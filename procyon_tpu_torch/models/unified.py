"""The protein side of UnifiedProCyon (counterpart of the protein-encoding
part of procyon_tpu/models/unified.py): ESM2 encoding, pooling, chunk
regrouping and the shared retrieval projector, i.e. the target side of
retrieval and the all-protein embedding sweeps.

The Llama query side, soft-token injection and the fusion forward are the
next slice (ROADMAP.md).
"""

import dataclasses
from typing import Optional

import torch

from procyon_tpu_torch.models import esm2, pooling, projectors


@dataclasses.dataclass(frozen=True)
class UnifiedProteinConfig:
    """The protein-side subset of procyon_tpu's UnifiedConfig: the ESM2
    config, the shared projector's shape (retrieval_dim plus
    `shared_projector_layers or retrieval_projector_layers` and its
    hidden width) and protein_pooling."""
    esm: esm2.ESM2Config = dataclasses.field(
        default_factory=esm2.ESM2Config)
    retrieval_dim: int = 1024
    shared_projector_layers: int = 1
    shared_projector_hidden: int = 0
    protein_pooling: str = "mean"
    dtype: torch.dtype = torch.bfloat16


def shared_projector_config(cfg: UnifiedProteinConfig):
    return projectors.ProjectorConfig(
        in_dim=cfg.esm.dim, out_dim=cfg.retrieval_dim,
        n_layers=cfg.shared_projector_layers,
        hidden_dim=cfg.shared_projector_hidden, dtype=cfg.dtype)


def init_params(generator: torch.Generator, cfg: UnifiedProteinConfig, *,
                device=None):
    """{"esm": ..., "projectors": {"shared_projector": [...]}}: the same keys
    as the reference's tree, so a bridged reference tree drops in."""
    return {
        "esm": esm2.init_params(generator, cfg.esm, device=device),
        "projectors": {"shared_projector": projectors.init_params(
            generator, shared_projector_config(cfg), device=device)},
    }


def encode_proteins(params, cfg: UnifiedProteinConfig,
                    protein_tokens: torch.Tensor, *,
                    group_ids: Optional[torch.Tensor] = None,
                    num_groups: Optional[int] = None,
                    row_valid: Optional[torch.Tensor] = None):
    """ESM-encode residue tokens [R, Lp] -> pooled embeddings [R or G, De];
    group_ids/num_groups merge chunk rows of long proteins."""
    out = esm2.forward(params["esm"], cfg.esm, protein_tokens)
    token_mask = (protein_tokens != esm2.PAD_IDX).to(torch.int32)
    pooled = pooling.pool_tokens(out["hidden"], token_mask,
                                 cfg.protein_pooling)
    if group_ids is not None:
        method = cfg.protein_pooling if cfg.protein_pooling != "cls" \
            else "mean"
        pooled = pooling.regroup_chunks(pooled, group_ids, num_groups,
                                        row_valid=row_valid, method=method)
    return pooled


def target_protein_embeddings(params, cfg: UnifiedProteinConfig,
                              protein_embeds: torch.Tensor) -> torch.Tensor:
    """Protein embeddings -> shared retrieval space (target side)."""
    return projectors.apply(params["projectors"]["shared_projector"],
                            shared_projector_config(cfg),
                            protein_embeds.to(cfg.dtype))


def protein_embed_fn(cfg: UnifiedProteinConfig):
    """(params, tokens, group_ids, row_valid, num_groups) -> shared-space
    target embeddings: encode, pool, regroup, project. A plain callable;
    PyTorch runs it eagerly."""
    def fn(params, tokens, group_ids, row_valid, num_groups):
        raw = encode_proteins(params, cfg, tokens, group_ids=group_ids,
                              num_groups=num_groups, row_valid=row_valid)
        return target_protein_embeddings(params, cfg, raw)
    return fn
