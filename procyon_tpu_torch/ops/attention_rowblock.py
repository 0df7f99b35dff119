"""Row-block attention (counterpart of procyon_tpu/ops/attention_rowblock.py).

Bidirectional attention over flat `[B, S, H*D]` activations with rotate-half
rotary fused, segment masking, exp2 score space, P cast to V's dtype before
P.V, and exactly-zero dead rows: the function of the TPU kernel
`_rowblock_packed_kernel`.

`rowblock_attention` is the one wrapper. On a CUDA tensor it launches the
hand-written kernel in csrc/rowblock_attention.cu (bf16 only) or raises; on
a CPU tensor it runs `rowblock_attention_ref`, the plain PyTorch version of
the same function. `launches` counts kernel launches.

The two JAX entry points map onto it:
  * `rowblock_packed_qkv_fwd`: q/k/v as strided views of the packed
    `[B, S, 3*H*D]` QKV projection (the kernel reads them without copies);
  * `rowblock_packed_fwd`: separate `[B, S, H, D]` q/k/v. The kernel takes
    the sequence length as an argument, so no padding to 128 is needed.
  * `rowblock_fwd` (the TPU kernel `_rowblock_kernel`): BSHD q/k/v with
    grouped-query heads, causal option and log-sum-exp. It is the function
    the flash forward computes, in the same base-2 score space, so it
    launches that kernel (csrc/flash_attention_fwd.cu). `flash_attention`
    with backend="rowblock" reaches the same launch directly where the
    packed kernel does not apply (head_dim 24 of ESM2-35M).
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from procyon_tpu_torch.ops import _build, flash_attention
from procyon_tpu_torch.ops.rotary import apply_rope_flat

MASK_VALUE = -1e30
LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

launches = 0

_SIG = {"rowblock_attention_bf16": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
           ctypes.c_void_p]}

Rope = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fold_rope(rope: Rope, sm_scale: float) -> Rope:
    """Fold sm_scale*log2(e) into the q-side tables, in the tables' dtype
    (the reference folds it after the tables are cast to the activation
    dtype: attention_rowblock.py:260-266)."""
    f = sm_scale * LOG2E
    return (rope[0] * f, rope[1] * f, rope[2], rope[3])


def rowblock_attention_ref(q, k, v, seg, *, head_dim: int,
                           score_scale: float,
                           rope: Optional[Rope] = None) -> torch.Tensor:
    """Plain PyTorch version. q/k/v [B, S, H*D] (any strides), seg [B, S]
    int, rope None or folded (cos_q, sin_q, cos_k, sin_k) [S, H*D] tables.
    Returns [B, S, H*D] in q's dtype."""
    B, S, HD = q.shape
    D = head_dim
    H = HD // D
    if rope is not None:
        q = apply_rope_flat(q, rope[0], rope[1], D)
        k = apply_rope_flat(k, rope[2], rope[3], D)
    qh = q.reshape(B, S, H, D).float()
    kh = k.reshape(B, S, H, D).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * score_scale
    seg = seg.to(torch.int32)
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    bias = torch.where(allowed, 0.0, MASK_VALUE).to(torch.float32)
    s = s + bias[:, None]
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    dead = (m <= MASK_VALUE * 0.5) | (l == 0.0)
    scale = torch.where(dead, 0.0, 1.0 / torch.where(dead, 1.0, l))
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                     v.reshape(B, S, H, D).float()) * scale
    return o.permute(0, 2, 1, 3).reshape(B, S, HD).to(q.dtype)


def check_kernel_layout(q, k, v, seg, head_dim: int,
                        rope: Optional[Rope] = None) -> None:
    """Raise unless the kernel can take these tensors: bf16 q/k/v of one
    shape [B, S, H*D] with one row and one batch stride and unit stride
    inside a row, head_dim in KERNEL_HEAD_DIMS, contiguous int32 seg
    [B, S], contiguous bf16 [S, H*D] rope tables, all on one device. The
    kernel copies 16-byte chunks (cp.async), so every base address is
    16-byte aligned and both strides are multiples of 8 elements. Reads
    shapes, strides and addresses only, on any device."""
    B, S, HD = q.shape
    D = head_dim
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"rowblock kernel takes bf16 q/k/v, got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS or HD % D:
        raise ValueError(f"rowblock kernel: head_dim {D} not in "
                         f"{KERNEL_HEAD_DIMS} or does not divide {HD}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    if not (q.stride() == k.stride() == v.stride()) or q.stride(-1) != 1:
        raise ValueError("q/k/v need one row stride, one batch stride and "
                         f"unit stride inside a row: {q.stride()} "
                         f"{k.stride()} {v.stride()}")
    if (any(t.data_ptr() % 16 for t in (q, k, v))
            or q.stride(0) % 8 or q.stride(1) % 8):
        raise ValueError("rowblock kernel copies 16-byte chunks: q/k/v need "
                         "16-byte aligned bases and row / batch strides that "
                         f"are multiples of 8, got strides {q.stride()} at "
                         f"offsets {[t.storage_offset() for t in (q, k, v)]}")
    if seg.shape != (B, S) or seg.dtype != torch.int32 \
            or not seg.is_contiguous():
        raise ValueError(f"seg must be contiguous int32 [B, S], got "
                         f"{seg.dtype} {tuple(seg.shape)}")
    dev = q.device
    if any(t.device != dev for t in (k, v, seg)):
        raise ValueError("q/k/v/seg on different devices")
    for t in rope or ():
        if (t.shape != (S, HD) or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != dev
                or t.data_ptr() % 16):
            raise ValueError("rope tables must be contiguous, 16-byte "
                             f"aligned bf16 [S, H*D] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(q, k, v, seg, head_dim, score_scale, rope) -> torch.Tensor:
    global launches
    check_kernel_layout(q, k, v, seg, head_dim, rope)
    B, S, HD = q.shape
    D = head_dim
    dev = q.device
    ptrs = [None] * 4 if rope is None else [t.data_ptr() for t in rope]
    out = torch.empty((B, S, HD), dtype=q.dtype, device=dev)
    lib = _build.load("rowblock_attention", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rowblock_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), *ptrs,
        out.data_ptr(), B, S, HD // D, D, q.stride(1), q.stride(0),
        score_scale, stream)
    _build.check(err, "rowblock_attention_bf16")
    launches += 1
    return out


def rowblock_attention(q, k, v, seg, *, head_dim: int, score_scale: float,
                       rope: Optional[Rope] = None) -> torch.Tensor:
    """Dispatch on the device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, nothing else. rope tables are already folded
    (`fold_rope`); with rope the scale lives in the tables and
    score_scale is 1."""
    _build.refuse_grad("rowblock attention", q, k, v)
    if q.is_cuda:
        return _launch(q, k, v, seg, head_dim, score_scale, rope)
    if q.device.type != "cpu":
        raise ValueError(f"no rowblock attention for device {q.device}")
    return rowblock_attention_ref(q, k, v, seg, head_dim=head_dim,
                                  score_scale=score_scale, rope=rope)


def _tables(rope, S, sm_scale, dtype) -> Optional[Rope]:
    if rope is None:
        return None
    folded = fold_rope(tuple(t[:S].to(dtype) for t in rope), sm_scale)
    return tuple(t.contiguous() for t in folded)


def rowblock_packed_qkv_fwd(qkv: torch.Tensor, seg: torch.Tensor, *,
                            n_heads: int, head_dim: int,
                            sm_scale: Optional[float] = None,
                            rope: Optional[Rope] = None) -> torch.Tensor:
    """Attention over the packed [B, S, 3*H*D] projection: q, k and v are
    column-offset views, never copied. rope: unfolded flat tables
    (cos_q, sin_q, cos_k, sin_k), [>=S, H*D]. Returns [B, S, H*D]."""
    B, S, three_hd = qkv.shape
    HD = n_heads * head_dim
    assert three_hd == 3 * HD, (qkv.shape, n_heads, head_dim)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    tables = _tables(rope, S, sm_scale, qkv.dtype)
    q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]
    return rowblock_attention(
        q, k, v, seg.to(torch.int32).contiguous(), head_dim=head_dim,
        score_scale=1.0 if rope is not None else sm_scale * LOG2E,
        rope=tables)


def rowblock_packed_fwd(q, k, v, seg, *, sm_scale: Optional[float] = None,
                        rope: Optional[Rope] = None) -> torch.Tensor:
    """q/k/v [B, S, H, D] -> [B, S, H, D]; Hq == Hkv, bidirectional."""
    B, S, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    tables = _tables(rope, S, sm_scale, q.dtype)
    out = rowblock_attention(
        q.reshape(B, S, H * D), k.reshape(B, S, H * D),
        v.reshape(B, S, H * D), seg.to(torch.int32).contiguous(),
        head_dim=D, score_scale=1.0 if rope is not None else sm_scale * LOG2E,
        rope=tables)
    return out.reshape(B, S, H, D)


def rowblock_fwd(q, k, v, seg_q, seg_kv, q_positions, kv_positions, *,
                 causal: bool, sm_scale: float, bounded: bool = False,
                 want_lse: bool = True):
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] (rotary already applied),
    seg / positions int32 [B, S]. Returns (out [B, Sq, Hq, D], lse
    [B, Hq, Sq] f32 natural log, or None): the contract of the flash
    forward, whose kernel and plain version it runs (`bounded` as there)."""
    return flash_attention.flash_fwd(
        q, k, v, seg_q, seg_kv, q_positions, kv_positions, causal=causal,
        sm_scale=sm_scale, bounded=bounded, want_lse=want_lse)
