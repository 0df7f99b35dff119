"""Probe: the one-pass fused LN + int8 MLP kernel against its two-pass form
(LN + row quantization, then the MLP on int8 rows) at ESM2-3B's MLP shape
(counterpart of scripts/probe_fused_mlp_blocks.py).

ESM2-3B (d 2560, H 10240) is ProCyon-Full's protein encoder; 32768 rows
are a B64 x L512 batch. Both forms add the residual. For each it prints the
kernel time (CUDA events, the two forms in turns: one, two, two, one), the
int8 rate (two products of 2 M d H operations) and the weight bytes the
product kernels re-stream (each row tile of the up kernel reads W1 once,
each of the down kernel's W2, from L2 or device memory). The row pass of
the two-pass form is timed alone as well.

    python -m procyon_tpu_torch.scripts.probe_fused_mlp_blocks \\
        [--dim 2560 --ffn 10240 --rows 32768]

The reference's `--configs` and `--scoped_kib` choose Mosaic block shapes
and its scoped-VMEM limit on the TPU; the CUDA kernels' tiles follow from
the requantization group (fused_mlp.UP_TILES, DOWN_TILE), so they have no
counterpart here. `--device cpu` runs both forms through the plain
versions at the given size and times nothing.
"""

import argparse
import json

import torch

from procyon_tpu_torch.ops import fused_mlp

ITERS = 5                   # calls a timing
SEED = 0


def make_inputs(M, d, H, dev, seed):
    """The reference probe's inputs: x ~ N(0, 0.25), LayerNorm weight ones
    and bias zeros, random int8 codes in [-127, 127] with scales 2e-4, zero
    biases."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    x = (torch.randn((M, d), generator=g, device=dev) * 0.5).to(dtype)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    return (x, torch.ones(d, device=dev), torch.zeros(d, device=dev),
            codes(d, H), torch.full((1, H), 2e-4, device=dev),
            torch.zeros(H, device=dev), codes(H, d),
            torch.full((1, d), 2e-4, device=dev), torch.zeros(d, device=dev))


def _ms(fn):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def run(d, H, M, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed check")
    args = make_inputs(M, d, H, dev, SEED)

    def one_pass():
        return fused_mlp.fused_ln_mlp_int8(*args, add_residual=True)

    def two_pass():
        return fused_mlp.fused_mlp_int8_prequant(*args, add_residual=True)

    with torch.no_grad():
        out1, out2 = one_pass(), two_pass()
        res = {"dim": d, "ffn": H, "rows": M,
               "finite": bool(torch.isfinite(out1.float()).all().item()
                              and torch.isfinite(out2.float()).all().item()),
               "max_abs_diff": (out1.float()
                                - out2.float()).abs().max().item(),
               "groups": {"one_pass": fused_mlp.requant_group(H),
                          "two_pass": fused_mlp.prequant_group(H)}}
        if dev.type == "cuda":
            a1 = _ms(one_pass)
            a2 = _ms(two_pass)
            b2 = _ms(two_pass)
            b1 = _ms(one_pass)
            rows_ms = _ms(lambda: fused_mlp.ln_quant_rows(*args[:3]))
            res.update(one_pass_ms=(a1 + b1) / 2, two_pass_ms=(a2 + b2) / 2,
                       ln_quant_ms=rows_ms,
                       row_tiles={k: (fused_mlp.UP_TILES[g][0],
                                      fused_mlp.DOWN_TILE[0])
                                  for k, g in res["groups"].items()})
    ops = 4 * M * d * H
    for k in ("one_pass", "two_pass"):
        ms = res.get(f"{k}_ms")
        res[f"{k}_tops"] = ops / (ms * 1e-3) / 1e12 if ms else None
        tiles = res.get("row_tiles", {}).get(k)
        res[f"{k}_weight_gb"] = sum(-(-M // t) for t in tiles) * d * H \
            / 1e9 if tiles else None
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=2560)
    ap.add_argument("--ffn", type=int, default=10240)
    ap.add_argument("--rows", type=int, default=32768)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = run(a.dim, a.ffn, a.rows, device=a.device)
    print(f"fused LN + int8 MLP M {a.rows} d {a.dim} H {a.ffn} (+ residual):")
    for k, what in (("one_pass", "one pass"), ("two_pass", "two passes")):
        ms = res.get(f"{k}_ms")
        if ms is None:
            print(f"  {what}: not measured (G {res['groups'][k]})")
            continue
        print(f"  {what}: {ms:8.3f} ms  {res[f'{k}_tops']:6.1f} TOP/s  "
              f"G {res['groups'][k]}, row tiles (up, down) "
              f"{res['row_tiles'][k]}: weights re-streamed "
              f"{res[f'{k}_weight_gb']:.2f} GB")
    if res.get("ln_quant_ms") is not None:
        print(f"  LN + row quantization alone: {res['ln_quant_ms']:.3f} ms")
    print(f"  max abs diff between the forms {res['max_abs_diff']:.4f} "
          "(their requantization groups differ)")
    print(json.dumps({"probe_fused_mlp_blocks": res}))
    return res


if __name__ == "__main__":
    main()
