"""int8 and int4 quantization (counterpart of procyon_tpu/ops/quant.py).

int8 tensors are {"q": int8 [..., in, out], "s": f32 [..., 1, out]}:
symmetric per-output-channel scales, rounding half to even as jnp.round.

int4 tensors are {"p": int8 [..., in/2, out], "s": f32 [..., in/group, 1,
out]}: group-wise symmetric 4-bit weights, two nibbles a byte along the
contraction axis (`quantize4`). The packing and the scales are a data
contract with the JAX package: the same f32 weights give the same bytes.

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

from procyon_tpu_torch.ops import int4_matmul


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
    return isinstance(node, dict) and len(node) == 2 and "q" in node \
        and "s" in node


def mm(x: torch.Tensor, w, mode: str = "dequant") -> torch.Tensor:
    """Matmul dispatching on quantized weight leaves: "dequant" =
    weight-only, "w8a8" = int8 x int8. int4 leaves are always weight-only
    (what they save is bytes)."""
    if not isinstance(w, dict):
        return x @ w
    if is_quantized(w):
        return qmatmul_w8a8(x, w) if mode == "w8a8" else qmatmul(x, w)
    if is_quantized4(w):
        return qmatmul4(x, w)
    raise TypeError(f"not a weight leaf: keys {sorted(w)}")


# ---------------------------------------------------------------------------
# int4 weight-only quantization: group-wise symmetric 4-bit, two nibbles
# packed per int8 byte along the contraction axis.
# ---------------------------------------------------------------------------

# the widest call (rows of x) that goes to the fused unpack + matmul kernel;
# wider ones dequantize the weight and take torch.matmul
KERNEL_MAX_ROWS = 256


def quantize4(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"p": int8 [..., in/2, out] packed nibbles,
    "s": f32 [..., in/group, 1, out] group scales}.

    Split-half packing: the low nibble of packed row r holds original row
    r, the high nibble row r + in/2, so unpacking gives two contiguous
    slabs. Affine nibble encoding: the low nibble is stored biased (q + 8,
    in [1, 15]), the high nibble holds the signed q, so the signed byte is
    q_hi * 16 + (q_lo + 8).

    Stacked [L, in, out] leaves go one layer at a time so the f32 temporary
    stays one layer's size. The group size is k / s.shape[-3]."""
    if w.dim() == 3:
        parts = [quantize4(w[i], group=group) for i in range(w.shape[0])]
        return {"p": torch.stack([p["p"] for p in parts]),
                "s": torch.stack([p["s"] for p in parts])}
    wf = w.float()
    *lead, k, n = wf.shape
    if group % 2 or k % (2 * group):
        # groups must stay nibble-pure: whole groups in each half of k
        raise ValueError(f"quantize4: the contraction dim {k} is not a "
                         f"multiple of twice the group size {group}")
    wg = wf.reshape(*lead, k // group, group, n)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) / 7.0
    q = torch.round(wg / scale).clamp(-7, 7).to(torch.int32)
    q = q.reshape(*lead, k, n)
    lo = q[..., : k // 2, :] + 8                       # biased, [1, 15]
    hi = q[..., k // 2:, :]                            # signed
    # the shift runs in int32 and the cast keeps the low byte: the
    # reference's int8 arithmetic with wrap-around
    packed = (((lo & 0x0F) | (hi << 4)) & 0xFF).to(torch.uint8).view(
        torch.int8)
    return {"p": packed, "s": scale}


def unpack4(p: torch.Tensor) -> torch.Tensor:
    """Packed nibbles int8 [..., k/2, n] -> signed q int8 [..., k, n]."""
    lo = (p & 0x0F) - 8                                # un-bias
    hi = p >> 4                                        # arithmetic on int8
    return torch.cat([lo, hi], dim=-2)


def dequantize4(qw, dtype=torch.bfloat16) -> torch.Tensor:
    p = qw["p"]
    *lead, k2, n = p.shape
    k = k2 * 2
    group = k // qw["s"].shape[-3]
    wg = unpack4(p).reshape(*lead, k // group, group, n).float()
    return (wg * qw["s"]).reshape(*lead, k, n).to(dtype)


def takes_kernel4(rows: int, qw) -> bool:
    """The reference's rule for its fused kernel, with the card in the
    TPU's place: a 2-D `p`, at most KERNEL_MAX_ROWS rows, n a multiple of
    128 and nibble-pure groups."""
    p = qw["p"]
    if rows > KERNEL_MAX_ROWS or p.dim() != 2:
        return False
    k2, n = p.shape
    return n % 128 == 0 and k2 % (2 * k2 // qw["s"].shape[0]) == 0


def qmatmul4(x: torch.Tensor, qw) -> torch.Tensor:
    """x @ dequant4(qw). Calls of at most KERNEL_MAX_ROWS rows go through
    ops/int4_matmul.qmatvec4 (the hand-written kernel on a CUDA tensor, its
    plain version on a CPU tensor): the packed nibbles are what crosses
    device memory. Wider calls (long prefills) dequantize the weight and
    take one torch.matmul, as the reference leaves them to XLA."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if takes_kernel4(rows, qw):
        return int4_matmul.qmatvec4(x, qw)
    return x @ dequantize4(qw, x.dtype)


def is_quantized4(node) -> bool:
    return isinstance(node, dict) and len(node) == 2 and "p" in node \
        and "s" in node


_TREE_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def quantize_tree4(params, *, keys=_TREE_KEYS, group: int = 128):
    """int4 variant of quantize_tree: leaves whose contraction dim is not a
    multiple of 2 * group fall back to int8."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in keys and isinstance(node, torch.Tensor) \
                and node.dim() >= 2:
            if node.shape[-2] % (2 * group) == 0:
                return quantize4(node, group=group)
            return quantize(node)
        return node

    return walk(params)


def quantize_tree(params, *, keys=_TREE_KEYS):
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
