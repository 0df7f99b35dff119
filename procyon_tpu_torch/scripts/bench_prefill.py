"""Prefill (teacher-forcing) throughput of an int8 Llama-class decoder:
weight-only ("dequant") against s8 x s8 ("w8a8") products (counterpart of
scripts/bench_prefill.py).

Defaults are the reference's: bench_bind's decoder (dim 4096, 30 layers,
int8 weights, about 5.6 B parameters) on B4 x S2048 random tokens; a call
is `llama.forward` over the batch and the LM head at the last position (the
reference's jit leaves the head's other positions to dead-code
elimination). The timed weights are constants, as in bench_bind.

    python -m procyon_tpu_torch.scripts.bench_prefill [--dim 4096
        --layers 30 --batch 4 --seq 2048]

It prints ms a call and prefill tokens/s for each mode and one JSON line
with both and the card's name, power limit and canary. `--device cpu` runs
both modes in f32, untimed. `main(argv)` returns the line as a dict;
`prefill_logits` and `run` take a caller's own weights.
"""

import argparse
import dataclasses
import json

import numpy as np
import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import llama
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.scripts import bench_bind
from procyon_tpu_torch.utils import timing

MODES = ("dequant", "w8a8")


def prefill_tokens(lcfg, B, S, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(4, lcfg.vocab_size, (B, S)),
                           dtype=torch.int32, device=torch.device(device))


def prefill_logits(params, lcfg, tokens, mode):
    """Logits [B, vocab] f32 at the last position of a full prefill in
    `mode`."""
    c = dataclasses.replace(lcfg, quant_mode=mode)
    out = llama.forward(params, c, tokens=tokens, want_logits=False)
    return quant.mm(out["hidden"][:, -1], params["lm_head"]).float()


def run(params, lcfg, batch=4, seq=2048, *, device="cuda"):
    lcfg = dataclasses.replace(lcfg, max_seq_len=max(lcfg.max_seq_len, seq))
    tokens = prefill_tokens(lcfg, batch, seq, device)
    res = {"logits": {}, "ms": {}, "tokens_per_sec": {}}
    with torch.no_grad():
        for mode in MODES:
            logits = prefill_logits(params, lcfg, tokens, mode)
            res["logits"][mode] = logits.cpu()
            t = None
            if torch.device(device).type == "cuda":
                t = timing.time_fn(
                    lambda: prefill_logits(params, lcfg, tokens, mode),
                    **bench_bind.TIMING)
            res["ms"][mode] = t * 1e3 if t else None
            res["tokens_per_sec"][mode] = batch * seq / t if t else None
    res["finite"] = all(bool(torch.isfinite(v).all().item())
                        for v in res["logits"].values())
    timed = res["ms"]["w8a8"] is not None
    n_params = sum(v.numel() for v in bridge.tree_leaves(params))
    res["line"] = {
        "metric": "prefill_tokens_per_sec_chip",
        "value": {m: round(v) if v else None
                  for m, v in res["tokens_per_sec"].items()},
        "unit": f"prefill tokens/sec (B{batch} x S{seq}, "
                f"~{n_params / 1e9:.1f}B int8 decoder)",
        "per_call_ms": {m: round(v, 2) if v else None
                        for m, v in res["ms"].items()},
        **(timing.canary_fields() if timed else {"timed": False})}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed run")
    cfg = bench_bind.device_config(a.device, dim=a.dim, layers=a.layers,
                                   prompt_len=a.seq)
    params = bench_bind.constant_params(cfg, a.device)["llama"]
    n = sum(v.numel() for v in bridge.tree_leaves(params))
    print(f"params: {n / 1e9:.2f}B", flush=True)
    res = run(params, cfg.llama, a.batch, a.seq, device=a.device)
    for mode in MODES:
        ms = res["ms"][mode]
        if ms is None:
            print(f"{mode:8s}: not measured (CPU run)")
        else:
            print(f"{mode:8s}: {ms:8.2f} ms  "
                  f"{res['tokens_per_sec'][mode]:,.0f} prefill tok/s/chip")
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    main()
