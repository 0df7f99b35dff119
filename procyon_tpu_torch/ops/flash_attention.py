"""Blockwise (flash) attention, forward only (counterpart of
procyon_tpu/ops/flash_attention.py).

Layout: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq % Hkv == 0. Segment
ids are int [B, S], id 0 is padding. Position (i, j) may attend iff
seg_q[i] == seg_kv[j] != 0 (and q_pos[i] >= kv_pos[j] when causal). Fully
masked query rows produce zeros.

  * `mha_reference`: the O(S^2)-memory reference (natural exp, f32), any
    device; `flash_attention(backend="ref")` takes it for CPU tensors.
  * `flash_fwd_ref`: the plain PyTorch version of the kernel: base-2 score
    space, P cast to V's dtype before P.V, f32 accumulation, lse -1e30 on
    dead rows.
  * `flash_fwd`: the one wrapper. On a CUDA tensor it launches the
    hand-written kernel in csrc/flash_attention_fwd.cu (bf16 only) or
    raises; on a CPU tensor it runs `flash_fwd_ref`. `launches` counts
    kernel launches.
  * `flash_attention`: the public entry with the reference's arguments. The
    kernel takes Sq and Skv as they are, so nothing is padded to 128.

The backward kernels (training) are not ported yet (ROADMAP.md, queue 2,
rows 8 and 9).
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from procyon_tpu_torch.ops import _build
from procyon_tpu_torch.ops.rotary import apply_rope_flat

DEFAULT_MASK_VALUE = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
KERNEL_HEAD_DIMS = (16, 24, 32, 64, 128)

launches = 0

_SIG = {"flash_attention_fwd_bf16":
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}

Rope = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _allowed(seg_q, seg_kv, causal, q_positions, kv_positions):
    """[B, Sq, Skv] bool."""
    allowed = (seg_q[:, :, None] == seg_kv[:, None, :]) \
        & (seg_q[:, :, None] > 0)
    if causal:
        allowed = allowed & (q_positions[:, :, None]
                             >= kv_positions[:, None, :])
    return allowed


def mask_inputs(q, k, seg_q, seg_kv, q_positions, kv_positions):
    """(seg_q, seg_kv, q_positions, kv_positions) as contiguous int32
    [B, S] on q's device, with the defaults for what is None: one segment,
    positions equal to the row indices. Numpy collators hand over int64."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    dev = q.device

    def arange(S):
        return torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)

    def ones(S):
        return torch.ones((B, S), dtype=torch.int32, device=dev)

    seg_q = ones(Sq) if seg_q is None else seg_q
    seg_kv = ones(Skv) if seg_kv is None else seg_kv
    q_positions = arange(Sq) if q_positions is None else q_positions
    kv_positions = arange(Skv) if kv_positions is None else kv_positions
    return tuple(t.to(device=dev, dtype=torch.int32).contiguous()
                 for t in (seg_q, seg_kv, q_positions, kv_positions))


def mha_reference(q, k, v, seg_q=None, seg_kv=None, *, causal=False,
                  sm_scale=None, q_positions=None, kv_positions=None):
    """O(S^2)-memory reference attention with the kernel's masking
    semantics: f32 throughout, natural exp, dead rows 0."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    seg_q, seg_kv, q_positions, kv_positions = mask_inputs(
        q, k, seg_q, seg_kv, q_positions, kv_positions)
    kf = k.repeat_interleave(group, dim=2) if group > 1 else k
    vf = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * sm_scale
    allowed = _allowed(seg_q, seg_kv, causal, q_positions,
                       kv_positions)[:, None]
    s = torch.where(allowed, s, DEFAULT_MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(allowed, p, 0.0)
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf.float())
    row_valid = allowed.any(-1).permute(0, 2, 1)[..., None]   # [B,Sq,1,1]
    return torch.where(row_valid, out, 0.0).to(q.dtype)


def flash_fwd_ref(q, k, v, seg_q, seg_kv, q_positions, kv_positions, *,
                  causal: bool, sm_scale: float):
    """Plain PyTorch version of the kernel. Returns (out [B, Sq, Hq, D] in
    q's dtype, lse [B, Hq, Sq] f32, natural log)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    group = Hq // Hkv
    kf = k.repeat_interleave(group, dim=2) if group > 1 else k
    vf = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) \
        * (sm_scale * LOG2E)
    allowed = _allowed(seg_q, seg_kv, causal, q_positions,
                       kv_positions)[:, None]
    s = torch.where(allowed, s, DEFAULT_MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    dead = (m <= DEFAULT_MASK_VALUE * 0.5) | (l == 0.0)
    l_safe = torch.where(dead, 1.0, l)
    inv = torch.where(dead, 0.0, 1.0 / l_safe)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                       vf.float()) * inv
    lse = torch.where(dead, DEFAULT_MASK_VALUE, m * LN2 + torch.log(l_safe))
    return out.permute(0, 2, 1, 3).to(q.dtype), lse[..., 0]


def _strides(t, what):
    """(batch, row, head) strides of a [B, S, H, D] view the kernel can
    read 16 bytes at a time: unit stride inside a head, every head row on
    a 16-byte boundary."""
    strides = t.stride()[:3]
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % 8 for s in strides)):
        raise ValueError(
            f"{what} needs unit stride inside a head and head rows on "
            f"16-byte boundaries, got strides {t.stride()} at offset "
            f"{t.storage_offset()}")
    return strides


def _launch(q, k, v, seg_q, seg_kv, q_positions, kv_positions, causal,
            sm_scale, bounded, want_lse):
    global launches
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernel takes bf16 q/k/v, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if (k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or Hq % Hkv
            or min(B, Sq, Skv) == 0):
        raise ValueError(f"q/k/v shapes do not fit: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    dev = q.device
    ints = (seg_q, seg_kv, q_positions, kv_positions)
    for t, S in zip(ints, (Sq, Skv, Sq, Skv)):
        if (t.shape != (B, S) or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError("segment ids and positions must be contiguous "
                             f"int32 [B, S], got {t.dtype} {tuple(t.shape)}")
    if any(t.device != dev for t in (k, v) + ints):
        raise ValueError("q/k/v/segments/positions on different devices")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev) \
        if want_lse else None
    lib = _build.load("flash_attention_fwd", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(t.data_ptr() for t in ints), out.data_ptr(),
            lse.data_ptr() if want_lse else None, B, Sq, Skv, Hq, Hkv, D,
            *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
            sm_scale * LOG2E, int(causal), int(bounded), stream)
    _build.check(err, "flash_attention_fwd_bf16")
    launches += 1
    return out, lse


def flash_fwd(q, k, v, seg_q, seg_kv, q_positions, kv_positions, *,
              causal: bool, sm_scale: float, bounded: bool = False,
              want_lse: bool = False):
    """Dispatch on the device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, nothing else. seg/positions int32 [B, S].
    `bounded` (positions are the row indices, Sq == Skv) lets the kernel
    skip causal key tiles above the diagonal. Returns (out, lse or None)."""
    if q.is_cuda:
        return _launch(q, k, v, seg_q, seg_kv, q_positions, kv_positions,
                       causal, sm_scale, bounded, want_lse)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    out, lse = flash_fwd_ref(q, k, v, seg_q, seg_kv, q_positions,
                             kv_positions, causal=causal, sm_scale=sm_scale)
    return out, (lse if want_lse else None)


def _apply_rope_4d(x, cos, sin_signed):
    """Flat rotary on x [B, S, H, D] with [>=S, H*D] sign-folded tables."""
    B, S, H, D = x.shape
    return apply_rope_flat(x.reshape(B, S, H * D), cos[:S], sin_signed[:S],
                           D).reshape(B, S, H, D)


def flash_attention(q, k, v, seg_q=None, seg_kv=None, *, causal=False,
                    sm_scale=None, q_positions=None, kv_positions=None,
                    backend: Optional[str] = None,
                    rope: Optional[Rope] = None):
    """Attention entry point; see the module docstring for layout and
    masking.

    backend: None (the flash kernel on a CUDA tensor, its plain version on
    a CPU tensor), "rowblock" (the packed row-block kernel with fused
    rotary where it applies, else the same as None: the single-pass
    row-block function is the one the flash kernel computes) or "ref"
    (`mha_reference`, for CPU tensors only). q_positions / kv_positions
    [B, S] override the index-based causal comparison (KV-cache prefill,
    left-padded prompts). rope: optional (cos_q, sin_q, cos_k, sin_k) flat
    sign-folded tables; q and k are then given pre-rotary and rotated
    here (inside the packed row-block kernel on that route). Only valid
    when all rows share positions arange(S) (the ESM2 encoder).
    Returns out [B, Sq, Hq, D]; the log-sum-exp is `flash_fwd`'s.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    if backend not in (None, "rowblock", "ref"):
        raise ValueError(f"unknown attention backend {backend!r}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bounded = q_positions is None and kv_positions is None and Sq == Skv

    if (backend == "rowblock" and not causal and bounded and Hq == Hkv
            and (seg_kv is None or seg_kv is seg_q)
            and (Hq * D) % 128 == 0 and 128 % D == 0):
        from procyon_tpu_torch.ops.attention_rowblock import \
            rowblock_packed_fwd
        if seg_q is None:
            seg_q = torch.ones((B, Sq), dtype=torch.int32, device=q.device)
        return rowblock_packed_fwd(q, k, v, seg_q, sm_scale=sm_scale,
                                   rope=rope)
    if rope is not None:
        q = _apply_rope_4d(q, rope[0], rope[1])
        k = _apply_rope_4d(k, rope[2], rope[3])
    ints = mask_inputs(q, k, seg_q, seg_kv, q_positions, kv_positions)
    if backend == "ref":
        if q.device.type != "cpu":
            raise ValueError(
                "backend='ref' is the CPU reference; a tensor on "
                f"{q.device} takes backend None or 'rowblock'")
        return mha_reference(q, k, v, ints[0], ints[1], causal=causal,
                             sm_scale=sm_scale, q_positions=ints[2],
                             kv_positions=ints[3])
    return flash_fwd(q, k, v, *ints, causal=causal, sm_scale=sm_scale,
                     bounded=bounded)[0]
