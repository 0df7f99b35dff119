"""Retrieval-query throughput (counterpart of scripts/bench_retrieval.py,
BASELINE.md workload 2: ProCyon-Split retrieval).

A query is one decoder forward over the prompt, the [PROT] token's hidden
state through the lm projector (`unified.retrieval_query_embedding`), then a
bf16 score against a cache of target embeddings and a top-10. Queries are
prefill-shaped, so the W8A8 products apply.

Defaults are the reference's: bench_bind's decoder (dim 4096, 30 layers,
int8, about 5.6 B parameters), B16 x L256 prompts with one protein soft
token at position 2, the query read at L - 1, 57,000 cached targets of
width 1024 (the reference scores all of its proteins). The timed weights
are constants, as in the reference.

    python -m procyon_tpu_torch.scripts.bench_retrieval [--dim 4096
        --layers 30 --batch 16 --prompt_len 256 --n_targets 57000]

It prints one JSON line, `retrieval_queries_per_sec_chip`, with the card's
name, power limit and canary. `--device cpu` runs it in f32, untimed.
`main(argv)` returns the line as a dict; `retrieval_batch`, `retrieve` and
`run` take a caller's own weights.
"""

import argparse
import json

import numpy as np
import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import unified
from procyon_tpu_torch.scripts import bench_bind
from procyon_tpu_torch.utils import timing

TOP_K = 10


def retrieval_batch(cfg, B, L, n_targets, device, seed=0):
    """(batch, targets): B prompts of L tokens, one protein soft token at
    position 2, the query at L - 1; n_targets bf16 target embeddings
    N(0, 1/32^2) of width cfg.retrieval_dim."""
    rng = np.random.default_rng(seed)
    soft_map = np.full((B, L), -1, np.int32)
    soft_map[:, 2] = 0
    ids = rng.integers(4, cfg.llama.vocab_size, (B, L))
    embeds = rng.standard_normal((1, cfg.protein_embed_dim))
    targets = rng.standard_normal((n_targets, cfg.retrieval_dim)) / 32
    dev = torch.device(device)
    batch = {
        "input_ids": torch.as_tensor(ids, dtype=torch.int32, device=dev),
        "seg_ids": torch.ones((B, L), dtype=torch.int32, device=dev),
        "positions": torch.arange(L, dtype=torch.int32,
                                  device=dev).expand(B, L),
        "soft_map": torch.as_tensor(soft_map, device=dev),
        "protein_embeds": torch.as_tensor(embeds, dtype=torch.float32,
                                          device=dev),
        "ret_pos": torch.full((B,), L - 1, dtype=torch.long, device=dev),
    }
    return batch, torch.as_tensor(targets, dtype=torch.float32,
                                  device=dev).to(torch.bfloat16)


def retrieve(params, cfg, batch, targets, k=TOP_K):
    """(query embeddings [B, R], top-k scores [B, k] f32, ids [B, k])."""
    q = unified.retrieval_query_embedding(params, cfg, batch)
    scores = q.to(torch.bfloat16) @ targets.T
    top = torch.topk(scores.float(), k, dim=-1)
    return q, top.values, top.indices


def run(params, cfg, batch_size=16, prompt_len=256, n_targets=57000, *,
        device="cuda"):
    batch, targets = retrieval_batch(cfg, batch_size, prompt_len,
                                     n_targets, device)
    with torch.no_grad():
        q, vals, ids = retrieve(params, cfg, batch, targets)
        res = {"query": q.float().cpu(), "top_ids": ids.cpu(),
               "finite": bool(torch.isfinite(q.float()).all().item())}
        t = None
        if torch.device(device).type == "cuda":
            t = timing.time_fn(lambda: retrieve(params, cfg, batch,
                                                targets)[1],
                               **bench_bind.TIMING)
    n_params = sum(v.numel() for v in bridge.tree_leaves(params["llama"]))
    res["line"] = {
        "metric": "retrieval_queries_per_sec_chip",
        "value": round(batch_size / t, 2) if t else None,
        "unit": f"queries/sec (L={prompt_len} prompt, ~{n_params / 1e9:.1f}"
                f"B decoder {cfg.llama.quant_mode}, {n_targets} cached "
                f"targets, top-{TOP_K})",
        "per_batch_ms": round(t * 1e3, 2) if t else None,
        **(timing.canary_fields() if t else {"timed": False})}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prompt_len", type=int, default=256)
    ap.add_argument("--n_targets", type=int, default=57000)
    ap.add_argument("--quant_mode", default="w8a8",
                    choices=("w8a8", "dequant"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed run")
    cfg = bench_bind.device_config(a.device, dim=a.dim, layers=a.layers,
                                   prompt_len=a.prompt_len,
                                   quant_mode=a.quant_mode)
    params = bench_bind.constant_params(cfg, a.device)
    res = run(params, cfg, a.batch, a.prompt_len, a.n_targets,
              device=a.device)
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    main()
