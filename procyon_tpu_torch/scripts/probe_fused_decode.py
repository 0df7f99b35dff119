"""Probe: the fused int8 decode MLP kernel against the port's int8 route
and bf16 weights, at a few rows (counterpart of scripts/probe_fused_decode.py).

Chains `--layers` distinct-weight MLP layers (rms_norm -> gate / up ->
SiLU(g) * u -> down -> residual) at `--m` rows and reports microseconds a
layer for three routes:

  int8    the port's weight-only int8 route, as llama.paged_forward runs a
          decode layer's MLP (rms_norm, quant.mm in "dequant" mode three
          times, silu * up, the residual);
  kernel  ops/fused_decode.fused_decode_mlp (csrc/fused_decode_mlp.cu):
          every weight byte streamed once;
  bf16    the same weights dequantized to bf16 ahead of time, `x @ w`;

beside the floors of int8 and bf16 weight streaming at 3.35 TB/s (the
H100's memory rate) and the largest difference between the kernel's and
the int8 route's outputs after the chain. The layers' weights (5.6 GB of
int8 at Llama-3-8B width and 32 layers) exceed the 50 MB L2 cache, so every
layer reads its weights from device memory. Times are CUDA events around
each chain, with the host kept ahead of the device by a spin kernel queued
first; the best of three chains.

On the card (weights made on the device from a seeded torch.Generator):

    python -m procyon_tpu_torch.scripts.probe_fused_decode \\
        --dim 4096 --inter 14336 --layers 32 --m 16

`--device cpu` runs the three routes in f32 through the plain versions
and times nothing.
"""

import argparse
import json
import math

import torch

from procyon_tpu_torch.ops import fused_decode, quant
from procyon_tpu_torch.ops.norms import rms_norm

PEAK_BYTES = 3.35e12        # H100 SXM device memory, bytes/s
SPIN_CYCLES = 40_000_000     # some 20 ms of device time
REPS = 3                     # timed chains a route, the best kept
SEED = 0


def build_layers(L, d, I, dev, seed):
    """Stacked int8 leaves with the reference probe's scales: random codes
    in [-127, 127], gate / up scaled by 1 / (127 sqrt(d)), down by half
    that; a norm weight of ones."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    sc = 1.0 / (127.0 * math.sqrt(d))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return {
        "nw": torch.ones((L, d), dtype=dtype, device=dev),
        "wg": {"q": codes(L, d, I),
               "s": torch.full((L, 1, I), sc, device=dev)},
        "wu": {"q": codes(L, d, I),
               "s": torch.full((L, 1, I), sc, device=dev)},
        "wd": {"q": codes(L, I, d),
               "s": torch.full((L, 1, d), sc / 2, device=dev)},
    }


def layer(layers, i):
    return {k: ({"q": v["q"][i], "s": v["s"][i]} if isinstance(v, dict)
                else v[i]) for k, v in layers.items()}


def int8_route(x, lp):
    """llama.paged_forward's MLP on int8 leaves (models/llama.py)."""
    h = rms_norm(x, lp["nw"], eps=1e-5)
    gated = torch.nn.functional.silu(quant.mm(h, lp["wg"])) \
        * quant.mm(h, lp["wu"])
    return x + quant.mm(gated, lp["wd"])


def kernel_route(x, lp):
    return fused_decode.fused_decode_mlp(x, lp["nw"], lp["wg"], lp["wu"],
                                         lp["wd"], eps=1e-5)


def bf16_route(x, lp):
    h = rms_norm(x, lp["nw"], eps=1e-5)
    gated = torch.nn.functional.silu(h @ lp["wg"]) * (h @ lp["wu"])
    return x + gated @ lp["wd"]


def dequantized(layers):
    """The bf16 route's weights: each int8 leaf as quant.qmatmul forms it."""
    out = {"nw": layers["nw"]}
    for k in ("wg", "wu", "wd"):
        q, s = layers[k]["q"], layers[k]["s"]
        out[k] = torch.stack([q[i].to(layers["nw"].dtype)
                              * s[i].to(layers["nw"].dtype)
                              for i in range(q.shape[0])])
    return out


def chain(fn, x, layers, L):
    for i in range(L):
        x = fn(x, layer(layers, i))
    return x


def chain_us(fn, x, layers, L):
    """Device microseconds a layer: the best of REPS timed chains, each
    queued behind a spin kernel so that the events bracket device work."""
    chain(fn, x, layers, L)                 # warm-up
    torch.cuda.synchronize()
    best = None
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        chain(fn, x, layers, L)
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) * 1e3 / L
        best = us if best is None else min(best, us)
    return best


def run(d, I, L, M, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed check")
    layers = build_layers(L, d, I, dev, SEED)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    x0 = torch.randn((M, d), generator=g).to(dev, layers["nw"].dtype)
    with torch.no_grad():
        ref = chain(int8_route, x0, layers, L)
        out = chain(kernel_route, x0, layers, L)
        wb = dequantized(layers)
        out_bf16 = chain(bf16_route, x0, wb, L)
        timed = dev.type == "cuda"
        res = {
            "dim": d, "inter": I, "layers": L, "m": M,
            "int8_us": chain_us(int8_route, x0, layers, L) if timed else None,
            "kernel_us": chain_us(kernel_route, x0, layers, L)
            if timed else None,
            "bf16_us": chain_us(bf16_route, x0, wb, L) if timed else None,
        }
    res["floor_us"] = 3 * d * I / PEAK_BYTES * 1e6
    res["bf16_floor_us"] = 2 * 3 * d * I / PEAK_BYTES * 1e6
    res["max_abs_diff"] = (out.float() - ref.float()).abs().max().item()
    res["bf16_max_abs_diff"] = (out_bf16.float()
                                - ref.float()).abs().max().item()
    res["ref_max"] = ref.float().abs().max().item()
    res["finite"] = bool(torch.isfinite(out.float()).all().item())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--inter", type=int, default=14336)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = run(a.dim, a.inter, a.layers, a.m, device=a.device)

    def us(v):
        return "not measured" if v is None else f"{v:9.2f} us/layer"

    print(f"fused decode MLP d {a.dim} I {a.inter} M {a.m}, {a.layers} "
          f"layers:")
    print(f"  int8 route:   {us(res['int8_us'])}")
    print(f"  kernel:       {us(res['kernel_us'])}")
    print(f"  bf16 x @ w:   {us(res['bf16_us'])}")
    print(f"  floor:        {res['floor_us']:9.2f} us/layer (int8 weight "
          f"streaming; bf16 {res['bf16_floor_us']:.2f})")
    print(f"  max abs diff {res['max_abs_diff']:.4f} kernel vs int8 route, "
          f"{res['bf16_max_abs_diff']:.4f} bf16 vs int8 route (int8 route's "
          f"max {res['ref_max']:.2f})")
    print(json.dumps({"probe_fused_decode": res}))
    return res


if __name__ == "__main__":
    main()
