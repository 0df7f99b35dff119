"""int8 quantization (counterpart of procyon_tpu/ops/quant.py).

Quantized tensors are {"q": int8 [..., in, out], "s": f32 [..., 1, out]}:
symmetric per-output-channel scales, rounding half to even as jnp.round.

W8A8 (`qmatmul_w8a8`): dynamic symmetric per-row activation quantization,
an s8 x s8 -> s32 product, then the row-scale x column-scale epilogue in
f32. The JAX package left these matmuls (the fused QKV projection and the
attention output projection) to XLA, outside any Pallas kernel; here the
product is `torch._int_mm` and the quantization and epilogue are torch
ops. On the H100 `torch._int_mm` ran as a CUTLASS sm80 wmma int8 tensor-op
kernel, not a cuBLASLt one (torch.profiler, PERF.md section 5); on the CPU
it is ATen's loop.
"""

from typing import Dict

import torch


def quantize(w: torch.Tensor, axis: int = -2) -> Dict[str, torch.Tensor]:
    """Per-output-channel int8 quantization of [..., in, out] (reduction
    over `in`). Stacked [L, in, out] leaves go one layer at a time so the
    f32 temporary stays one layer's size."""
    if w.dim() == 3 and axis == -2:
        parts = [quantize(w[i], axis=-2) for i in range(w.shape[0])]
        return {"q": torch.stack([p["q"] for p in parts]),
                "s": torch.stack([p["s"] for p in parts])}
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize(qw, dtype=torch.bfloat16) -> torch.Tensor:
    return (qw["q"].float() * qw["s"]).to(dtype)


def qmatmul(x: torch.Tensor, qw) -> torch.Tensor:
    """x @ dequant(qw) (weight-only int8)."""
    w = qw["q"].to(x.dtype) * qw["s"].to(x.dtype)
    return x @ w


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8: (xq int8 [..., K], sx f32 [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    sx = amax.clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    return xq, sx


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] x s8 [K, N] -> s32 [M, N], exact. The CUDA route
    of torch._int_mm wants more than 16 rows; short inputs are padded with
    zero rows."""
    M = a.shape[0]
    if a.is_cuda and M <= 16:
        a = torch.cat([a, a.new_zeros(32 - M, a.shape[1])])
        return torch._int_mm(a, b.contiguous())[:M]
    return torch._int_mm(a.contiguous(), b.contiguous())


def qmatmul_w8a8(x: torch.Tensor, qw) -> torch.Tensor:
    """Full-int8 matmul: per-row activation quantization x per-column
    weight scales, f32 epilogue, result in x's dtype."""
    xq, sx = quantize_rows(x)
    K = x.shape[-1]
    acc = int_mm(xq.reshape(-1, K), qw["q"]).reshape(*x.shape[:-1], -1)
    scale = sx * qw["s"].reshape((1,) * (x.dim() - 1) + (-1,))
    return (acc.float() * scale).to(x.dtype)


def is_quantized(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"q", "s"}


def mm(x: torch.Tensor, w, mode: str = "dequant") -> torch.Tensor:
    """Matmul dispatching on int8-quantized weight leaves: "dequant" =
    weight-only, "w8a8" = int8 x int8."""
    if is_quantized(w):
        return qmatmul_w8a8(x, w) if mode == "w8a8" else qmatmul(x, w)
    return x @ w


def quantize_tree(params, *, keys=("wq", "wk", "wv", "wo", "w_gate",
                                   "w_up", "w_down", "lm_head")):
    """Quantize the named weight leaves of a parameter tree (new tree);
    norms and biases keep their dtype."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in keys and isinstance(node, torch.Tensor) \
                and node.dim() >= 2:
            return quantize(node)
        return node

    return walk(params)
