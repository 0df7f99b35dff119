"""Entry point of the port (counterpart of `entry()` in the repository's
__graft_entry__.py).

entry(device) -> (fn, (params, batch)): the fusion model's forward in
retrieval mode (decoder + projectors + contrastive scoring) on a small but
structurally complete flagship config (a GQA decoder like Llama-3, a live
ESM2 encoder present) and its example batch, with random parameters drawn
from seed 0 on `device`. fn(params, batch) returns (logits,
retrieval_loss). The device defaults to the card; without one, pass
device="cpu". The multichip dry run is scripts/dryrun_multichip.py.
"""

import numpy as np
import torch

from procyon_tpu_torch.models import esm2, llama, unified


def example_batch(cfg, B=2, L=32, U=3, rng=None, *, device="cuda"):
    """The reference's `_example_batch`, the same draws from the same rng:
    one soft token at position 2, labels over the second half, the
    retrieval position at the last token."""
    rng = rng or np.random.default_rng(0)
    soft_map = np.full((B, L), -1, np.int32)
    soft_map[:, 2] = np.arange(B) % U
    labels = rng.integers(0, cfg.llama.vocab_size, (B, L)).astype(np.int32)
    labels[:, : L // 2] = -100
    dev = torch.device(device)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return {
        "input_ids": t(rng.integers(4, cfg.llama.vocab_size, (B, L))),
        "seg_ids": t(np.ones((B, L))),
        "positions": t(np.broadcast_to(np.arange(L), (B, L))),
        "soft_map": t(soft_map),
        "protein_embeds": t(rng.standard_normal((U, cfg.encoder_out_dim)),
                            torch.float32),
        "labels": t(labels),
        "ret_pos": t(np.full((B,), L - 1)),
        "ret_target_pos": t(np.arange(B) % U),
        "ret_valid": t(np.ones((B,)), torch.bool),
    }


def entry_config():
    """The reference entry's config: a 4-layer GQA decoder (dim 256, 8
    query and 2 KV heads), a 2-layer ESM2 (dim 128), bf16."""
    return unified.UnifiedConfig(
        llama=llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=4,
                                n_heads=8, n_kv_heads=2, intermediate=512,
                                max_seq_len=256, dtype=torch.bfloat16),
        esm=esm2.ESM2Config(dim=128, n_layers=2, n_heads=4,
                            dtype=torch.bfloat16, max_seq_len=128),
        token_projector_layers=3, token_projector_hidden=256,
        retrieval_dim=128, dtype=torch.bfloat16)


def entry(device=None):
    """(fn, (params, batch)) on `device` (default: the card)."""
    device = torch.device(device or "cuda")
    cfg = entry_config()
    params = unified.init_params(0, cfg, device=device)
    batch = example_batch(cfg, B=2, L=64, U=3, device=device)

    def fn(params, batch):
        out = unified.forward(params, cfg, batch, retrieval=True)
        return out["logits"], out["retrieval_loss"]

    return fn, (params, batch)
