"""UnifiedProCyon: the multimodal protein-phenotype fusion model
(counterpart of procyon_tpu/models/unified.py), inference paths.

A protein encoder (live ESM2 or frozen precomputed embeddings), MLP token
projectors into the LLM embedding space, a Llama decoder, retrieval
projectors and the in-batch InfoNCE head. The collator pre-computes a
fixed-shape `soft_map [B, L]` (-1 = ordinary vocab token, k >= 0 = "replace
with projected protein / struct / drug embedding number k") and injection
is one gather and select.

Forward modes:
  * lm:        causal-LM logits + masked loss (QA / caption)
  * retrieval: [PROT] hidden state -> lm projector vs target protein
               embeddings -> shared projector, InfoNCE
  * protein-only: `encode_proteins`, `target_protein_embeddings`,
               `protein_embed_fn` (the target side; `llama=None`
               describes a deployment of that side alone, with no decoder)

Batches are dicts of tensors on the parameters' device. Not ported yet
(ROADMAP.md): the ESM2 masked-LM head of the fusion model and the
cross-device contrastive batch (queue 1, training slice).
"""

import dataclasses
from typing import Optional

import torch

from procyon_tpu_torch.models import (contrastive, esm2, llama, pooling,
                                      projectors)
from procyon_tpu_torch.models._init import Seed, make_generator

# aliases: dataclass field names below shadow the module names in class scope
_LlamaConfig = llama.LlamaConfig
_ESM2Config = esm2.ESM2Config
_InfoNCEConfig = contrastive.InfoNCEConfig
_llama_tiny = llama.tiny_config


@dataclasses.dataclass(frozen=True)
class UnifiedConfig:
    # None => no decoder: the protein side alone (encoder + shared projector)
    llama: Optional[_LlamaConfig] = dataclasses.field(
        default_factory=_llama_tiny)
    esm: Optional[_ESM2Config] = None  # None => frozen-embedding mode
    protein_embed_dim: int = 2560  # ESM2-3B table width when esm is None
    # projector shapes (configs/llama3-full.yml: 3-layer, hidden 2560)
    token_projector_layers: int = 3
    token_projector_hidden: int = 2560
    retrieval_dim: int = 1024
    retrieval_projector_layers: int = 1
    # separate lm / shared projector shapes; None / 0 falls back to
    # retrieval_projector_layers
    lm_projector_layers: Optional[int] = None
    lm_projector_hidden: int = 0
    shared_projector_layers: Optional[int] = None
    shared_projector_hidden: int = 0
    use_drug_embeddings: bool = False
    drug_embed_dim: int = 512
    use_protein_struct: bool = False
    struct_embed_dim: int = 512
    protein_pooling: str = "mean"
    contrastive: _InfoNCEConfig = dataclasses.field(
        default_factory=_InfoNCEConfig)
    dtype: torch.dtype = torch.bfloat16

    @property
    def encoder_out_dim(self):
        return self.esm.dim if self.esm is not None else self.protein_embed_dim


def tiny_config(**kw) -> UnifiedConfig:
    base = dict(
        llama=llama.tiny_config(attn_backend="ref", remat=False),
        esm=esm2.tiny_config(attn_backend="ref"),
        protein_embed_dim=64, token_projector_layers=2,
        token_projector_hidden=32, retrieval_dim=16, dtype=torch.float32,
    )
    base.update(kw)
    return UnifiedConfig(**base)


def _proj_cfg(cfg, in_dim, out_dim, n_layers, hidden):
    return projectors.ProjectorConfig(
        in_dim=in_dim, out_dim=out_dim, n_layers=n_layers,
        hidden_dim=hidden, dtype=cfg.dtype)


def shared_projector_config(cfg: UnifiedConfig):
    layers = cfg.shared_projector_layers or cfg.retrieval_projector_layers
    return _proj_cfg(cfg, cfg.encoder_out_dim, cfg.retrieval_dim, layers,
                     cfg.shared_projector_hidden)


def projector_configs(cfg: UnifiedConfig):
    if cfg.llama is None:
        return {"shared_projector": shared_projector_config(cfg)}
    d_llm = cfg.llama.dim
    d_enc = cfg.encoder_out_dim
    lm_layers = cfg.lm_projector_layers or cfg.retrieval_projector_layers
    out = {
        "token_projector": _proj_cfg(cfg, d_enc, d_llm,
                                     cfg.token_projector_layers,
                                     cfg.token_projector_hidden),
        # retrieval: LLM side and protein side into the shared space
        "lm_projector": _proj_cfg(cfg, d_llm, cfg.retrieval_dim,
                                  lm_layers, cfg.lm_projector_hidden),
        "shared_projector": shared_projector_config(cfg),
    }
    if cfg.use_protein_struct:
        out["struct_projector"] = _proj_cfg(cfg, cfg.struct_embed_dim, d_llm,
                                            cfg.token_projector_layers,
                                            cfg.token_projector_hidden)
    if cfg.use_drug_embeddings:
        out["drug_projector"] = _proj_cfg(cfg, cfg.drug_embed_dim, d_llm,
                                          cfg.token_projector_layers,
                                          cfg.token_projector_hidden)
    return out


def init_params(seed: Seed, cfg: UnifiedConfig, *, device="cuda"):
    """The reference tree's keys, so a bridged reference tree drops in:
    {"llama", "projectors": {...}, "contrastive"[, "esm"]}; with
    `cfg.llama` None, {"esm", "projectors": {"shared_projector"}} alone.
    `seed` is an int or a generator on `device`."""
    generator, device = make_generator(seed, device)
    params = {}
    if cfg.llama is not None:
        params["llama"] = llama.init_params(generator, cfg.llama,
                                            device=device)
    params["projectors"] = {
        name: projectors.init_params(generator, pc, device=device)
        for name, pc in projector_configs(cfg).items()}
    if cfg.llama is not None:
        params["contrastive"] = contrastive.init_params(cfg.contrastive,
                                                        device=device)
    if cfg.esm is not None:
        params["esm"] = esm2.init_params(generator, cfg.esm, device=device)
    return params


# ---------------------------------------------------------------------------
# Protein encoding
# ---------------------------------------------------------------------------


def encode_proteins(params, cfg: UnifiedConfig,
                    protein_tokens: torch.Tensor, *,
                    group_ids: Optional[torch.Tensor] = None,
                    num_groups: Optional[int] = None,
                    row_valid: Optional[torch.Tensor] = None):
    """ESM-encode residue tokens [R, Lp] -> pooled embeddings [R or G, De];
    group_ids/num_groups merge chunk rows of long proteins."""
    if cfg.esm is None:
        raise ValueError("encode_proteins requires a live ESM encoder")
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


def target_protein_embeddings(params, cfg: UnifiedConfig,
                              protein_embeds: torch.Tensor) -> torch.Tensor:
    """Protein embeddings -> shared retrieval space (target side)."""
    return projectors.apply(params["projectors"]["shared_projector"],
                            shared_projector_config(cfg),
                            protein_embeds.to(cfg.dtype))


def protein_embed_fn(cfg: UnifiedConfig):
    """(params, tokens, group_ids, row_valid, num_groups) -> shared-space
    target embeddings: encode, pool, regroup, project. A plain callable;
    PyTorch runs it eagerly."""
    def fn(params, tokens, group_ids, row_valid, num_groups):
        raw = encode_proteins(params, cfg, tokens, group_ids=group_ids,
                              num_groups=num_groups, row_valid=row_valid)
        return target_protein_embeddings(params, cfg, raw)
    return fn


# ---------------------------------------------------------------------------
# Fusion forward
# ---------------------------------------------------------------------------


def _inject_soft_tokens(params, cfg, input_ids, soft_map, soft_bank):
    """Input embeddings with soft tokens scattered over the placeholder
    positions. soft_bank [P, dim]: projected modality embeddings (row k
    answers soft_map == k)."""
    tok_embeds = params["llama"]["embed"][input_ids.long()].to(cfg.dtype)
    if soft_bank is None or soft_map is None:
        return tok_embeds
    gathered = soft_bank[soft_map.long().clamp(0, soft_bank.shape[0] - 1)]
    return torch.where((soft_map >= 0)[..., None], gathered.to(cfg.dtype),
                       tok_embeds)


def build_soft_bank(params, cfg: UnifiedConfig, protein_embeds,
                    drug_embeds=None, struct_embeds=None):
    """Project modality embeddings into LLM token space -> one bank, in the
    row layout the collators index soft_map against:
    protein rows [0, U); struct rows [U, U+Us); drug rows [U+Us, U+Us+Ud).
    """
    pcfgs = projector_configs(cfg)
    banks = [projectors.apply(params["projectors"]["token_projector"],
                              pcfgs["token_projector"],
                              protein_embeds.to(cfg.dtype))]
    if struct_embeds is not None:
        banks.append(projectors.apply(
            params["projectors"]["struct_projector"],
            pcfgs["struct_projector"], struct_embeds.to(cfg.dtype)))
    if drug_embeds is not None:
        banks.append(projectors.apply(
            params["projectors"]["drug_projector"],
            pcfgs["drug_projector"], drug_embeds.to(cfg.dtype)))
    return banks[0] if len(banks) == 1 else torch.cat(banks, dim=0)


def _with_protein_embeds(params, cfg, batch):
    """The batch with "protein_embeds", encoding "protein_tokens" with the
    live encoder when they are not precomputed."""
    if batch.get("protein_embeds") is not None:
        return batch
    toks = batch["protein_tokens"]
    grouped = batch.get("protein_group_ids") is not None
    embeds = encode_proteins(
        params, cfg, toks, group_ids=batch.get("protein_group_ids"),
        num_groups=toks.shape[0] if grouped else None,
        row_valid=batch.get("protein_row_valid"))
    return {**batch, "protein_embeds": embeds}


def assemble_input_embeds(params, cfg: UnifiedConfig, batch):
    """Fused-prompt embedding assembly only: project the modality
    embeddings into the soft bank and scatter them over the placeholder
    positions."""
    batch = _with_protein_embeds(params, cfg, batch)
    soft_bank = build_soft_bank(params, cfg, batch["protein_embeds"],
                                drug_embeds=batch.get("drug_embeds"),
                                struct_embeds=batch.get("struct_embeds"))
    return _inject_soft_tokens(params, cfg, batch["input_ids"],
                               batch.get("soft_map"), soft_bank)


def _prot_hidden(hidden, ret_pos):
    B = hidden.shape[0]
    return hidden[torch.arange(B, device=hidden.device), ret_pos.long()]


def forward(params, cfg: UnifiedConfig, batch, *, retrieval=False,
            axis_name=None, kv_cache=None, lora_expert=0,
            want_logits: bool = True, max_position=None):
    """Run the fusion model.

    batch keys (all fixed-shape; produced by data/collators.py):
      input_ids [B, L], seg_ids [B, L], positions [B, L]
      soft_map [B, L]  (-1 or index into the soft bank)
      protein_embeds [U, De]: unique proteins (precomputed, or encoded
        here from protein_tokens); struct_embeds, drug_embeds optional
      labels [B, L] (-100 ignore): lm mode
      ret_pos [B]: index of the [PROT] token per row; ret_target_pos [B]:
        row into protein_embeds for the positive target; ret_valid [B]
        bool; conflict_mask [B, B], conflict_ids [B], ret_negative_pos
        [B, K] optional: retrieval mode
    want_logits=False skips the LM head (see llama.forward); the LM loss
    needs it. max_position is llama.forward's host-side bound of
    `positions`.
    """
    batch = _with_protein_embeds(params, cfg, batch)
    input_embeds = assemble_input_embeds(params, cfg, batch)
    out = llama.forward(params["llama"], cfg.llama,
                        input_embeds=input_embeds,
                        seg_ids=batch.get("seg_ids"),
                        positions=batch.get("positions"),
                        kv_cache=kv_cache, lora_expert=lora_expert,
                        want_logits=want_logits,
                        max_position=max_position)
    result = {"hidden": out["hidden"]}
    for key in ("logits", "kv_cache"):
        if key in out:
            result[key] = out[key]

    if retrieval:
        query = projectors.apply(params["projectors"]["lm_projector"],
                                 projector_configs(cfg)["lm_projector"],
                                 _prot_hidden(out["hidden"],
                                              batch["ret_pos"]))
        embeds = batch["protein_embeds"]
        targets = target_protein_embeddings(
            params, cfg, embeds[batch["ret_target_pos"].long()])
        if batch.get("ret_negative_pos") is not None:
            negs = target_protein_embeddings(
                params, cfg, embeds[batch["ret_negative_pos"].long()])
            loss, metrics = contrastive.info_nce_explicit(
                params["contrastive"], cfg.contrastive, targets, query,
                negs, valid=batch.get("ret_valid"))
        else:
            loss, metrics = contrastive.info_nce_in_batch(
                params["contrastive"], cfg.contrastive, targets, query,
                valid=batch.get("ret_valid"),
                conflict_mask=batch.get("conflict_mask"),
                conflict_ids=batch.get("conflict_ids"),
                axis_name=axis_name)
        result.update({"retrieval_loss": loss, "retrieval_metrics": metrics,
                       "query_embeds": query, "target_embeds": targets})

    if batch.get("labels") is not None:
        logits = out["logits"][:, :-1]
        labels = batch["labels"][:, 1:].long()
        mask = labels != -100
        safe = torch.where(mask, labels, 0)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        nll = torch.where(mask, nll, 0.0)
        result["lm_loss"] = nll.sum() / mask.sum().clamp_min(1)
        result["lm_token_count"] = mask.sum()
        # per-row loss for caption weighting
        result["lm_loss_per_row"] = nll.sum(-1) / mask.sum(-1).clamp_min(1)
    return result


def retrieval_query_embedding(params, cfg: UnifiedConfig, batch):
    """Inference-time retrieval: the query embedding only."""
    out = forward(params, cfg, batch, retrieval=False, want_logits=False)
    return projectors.apply(params["projectors"]["lm_projector"],
                            projector_configs(cfg)["lm_projector"],
                            _prot_hidden(out["hidden"], batch["ret_pos"]))


def quantize_params(params, cfg: UnifiedConfig):
    """Weight-only int8 quantization of both towers (decoder + encoder);
    projectors and the contrastive head stay full precision."""
    out = dict(params)
    out["llama"] = llama.quantize_params(params["llama"], cfg.llama)
    if cfg.esm is not None and "esm" in params:
        out["esm"] = esm2.quantize_params(params["esm"], cfg.esm)
    return out
