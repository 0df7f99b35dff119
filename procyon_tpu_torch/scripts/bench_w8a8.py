"""ESM2-650M protein embedding in bf16 and in W8A8 with fused QKV, with the
W8A8-against-bf16 cosine (counterpart of scripts/bench_w8a8.py).

The workload is bench.py's: B64 rows of L512 tokens whose proteins have
random lengths in [L/2, L-2) (`tokens_batch`), the ESM2 forward and mean
pooling over the non-pad tokens. Two routes on the same seeded weights:
bf16 (q / k / v apart) and the serving layout (int8 weights, fused QKV,
W8A8 products), each timed by utils/timing.time_fn (CUDA events, two
points at `TIMING`'s call counts). On the card the attention of both
routes is the packed row-block kernel (csrc/rowblock_attention.cu) and the
W8A8 route's MLP the fused LN + int8 MLP (csrc/fused_ln_mlp_int8.cu); the
line carries each route's launches of them.

    python -m procyon_tpu_torch.scripts.bench_w8a8 [--batch 64
        --seq_len 512 --size 650m --seed 0]

It prints one JSON line, `esm2_w8a8_proteins_per_sec_chip` (the W8A8
route's proteins/s, the bf16 route's beside it, the cosine, the card's
name, power limit and canary). `--device cpu` runs both routes in f32 and
times nothing. `main(argv)` returns the result as a dict; `tokens_batch`,
`embed` and `run` are the pieces a caller with its own weights uses.
"""

import argparse
import dataclasses
import json

import numpy as np
import torch

from procyon_tpu_torch.models import esm2, pooling
from procyon_tpu_torch.ops import launch_counts, launches_since
from procyon_tpu_torch.utils import timing

# utils/timing.time_fn's two points, the best of two runs each: a batch
# takes 0.3-0.6 s on the card
TIMING = dict(n_small=1, n_big=4, repeats=2, warmup=1)
LAUNCHES = ("rowblock_attention", "fused_ln_mlp_int8", "flash_attention_fwd")


def tokens_batch(batch, seq_len, seed=0, *, device="cuda"):
    """The reference's batch: row i holds CLS, n random residues (n drawn
    in [seq_len // 2, seq_len - 2)), EOS, then padding; the same draws."""
    rng = np.random.default_rng(seed)
    toks = np.full((batch, seq_len), esm2.PAD_IDX, np.int32)
    for i in range(batch):
        n = rng.integers(seq_len // 2, seq_len - 2)
        toks[i, 0] = esm2.CLS_IDX
        toks[i, 1:n + 1] = rng.integers(4, 24, n)
        toks[i, n + 1] = esm2.EOS_IDX
    return torch.as_tensor(toks, device=torch.device(device))


def bench_config(size="650m", seq_len=512, *, device="cuda"):
    """ESM2 on the row-block attention, bf16 on the card and f32 on the
    CPU."""
    on_cpu = torch.device(device).type == "cpu"
    return esm2.esm2_config(size, max_seq_len=seq_len,
                            dtype=torch.float32 if on_cpu else torch.bfloat16,
                            attn_backend="rowblock")


def serving_params(params, cfg):
    """The serving layout: int8 weights, q / k / v fused."""
    return esm2.fuse_qkv_params(esm2.quantize_params(params, cfg))


def embed(params, cfg, tokens):
    """Mean-pooled last hidden states [B, dim]."""
    mask = (tokens != esm2.PAD_IDX).to(torch.int32)
    return pooling.pool_tokens(esm2.forward(params, cfg, tokens)["hidden"],
                               mask, "mean")


def cosines(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-8)


@torch.no_grad()
def run(params, cfg, *, params8=None, batch=64, seq_len=512, seed=0,
        device="cuda", tokens=None):
    """Both routes on one batch: their embeddings, the cosine, each route's
    kernel launches for one call and, on the card, its time. params: the
    encoder's bf16 (or f32) tree; params8: its serving layout (made here
    when None)."""
    if params8 is None:
        params8 = serving_params(params, cfg)
    cfg8 = dataclasses.replace(cfg, quant_mode="w8a8")
    if tokens is None:
        tokens = tokens_batch(batch, seq_len, seed, device=device)
    on_card = torch.device(device).type == "cuda"
    res = {"embeddings": {}, "launches": {}, "ms": {}}
    for name, p, c in (("bf16", params, cfg), ("w8a8", params8, cfg8)):
        before = launch_counts()
        res["embeddings"][name] = embed(p, c, tokens)
        n = launches_since(before)
        res["launches"][name] = {k: n[k] for k in LAUNCHES}
        if on_card:
            res["ms"][name] = timing.time_fn(
                lambda: embed(p, c, tokens), **TIMING) * 1e3
    cos = cosines(res["embeddings"]["w8a8"], res["embeddings"]["bf16"])
    res["cos_min"] = float(cos.min())
    res["cos_mean"] = float(cos.mean())
    res["finite"] = all(bool(torch.isfinite(e.float()).all())
                        for e in res["embeddings"].values())
    B = tokens.shape[0]
    rate = {k: B / (v / 1e3) for k, v in res["ms"].items()}
    res["proteins_per_sec"] = rate
    res["line"] = {
        "metric": "esm2_w8a8_proteins_per_sec_chip",
        "value": round(rate["w8a8"], 2) if on_card else None,
        "unit": f"proteins/sec (ESM2 dim {cfg.dim} x {cfg.n_layers} "
                f"layers, B{B} x L{tokens.shape[1]}, W8A8 fused QKV, mean "
                "pooling)",
        "bf16_proteins_per_sec": round(rate["bf16"], 2) if on_card
        else None,
        "per_batch_ms": {k: round(v, 3) for k, v in res["ms"].items()},
        "w8a8_vs_bf16_cos_min": round(res["cos_min"], 6),
        "w8a8_vs_bf16_cos_mean": round(res["cos_mean"], 6),
        "launches_per_call": res["launches"],
        **(timing.canary_fields() if on_card else {"timed": False})}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq_len", type=int, default=512)
    ap.add_argument("--size", default="650m")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed run")
    cfg = bench_config(a.size, a.seq_len, device=a.device)
    params = esm2.init_params(a.seed, cfg, device=a.device)
    res = run(params, cfg, batch=a.batch, seq_len=a.seq_len, seed=a.seed,
              device=a.device)
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    main()
