"""Blockwise (flash) attention, forward and backward (counterpart of
procyon_tpu/ops/flash_attention.py).

Layout: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq % Hkv == 0. Segment
ids are int [B, S], id 0 is padding. Position (i, j) may attend iff
seg_q[i] == seg_kv[j] != 0 (and q_pos[i] >= kv_pos[j] when causal). Fully
masked query rows produce zeros.

  * `mha_reference`: the O(S^2)-memory reference (natural exp, f32), any
    device; `flash_attention(backend="ref")` takes it for CPU tensors.
  * `flash_fwd_ref`: the plain PyTorch version of the kernel: base-2 score
    space, P cast to V's dtype before P.V, f32 accumulation, dead rows 0
    and their lse -1e30 whatever the padded K / V rows hold.
  * `flash_fwd`: the one wrapper. On a CUDA tensor it launches the
    hand-written kernel in csrc/flash_attention_fwd.cu (bf16 only) or
    raises; on a CPU tensor it runs `flash_fwd_ref`. `launches` counts
    kernel launches.
  * `flash_bwd_ref`: the plain PyTorch version of the backward kernels,
    with their cast points: p against the forward's lse in base 2,
    bf16(p) before dv, ds rounded to q's dtype before dq and dk, f32 sums,
    dk and dv summed over a GQA group in f32 and rounded once.
  * `flash_bwd`: the one wrapper of the two backward kernels in
    csrc/flash_attention_bwd.cu (dq, which also computes delta; dk and dv),
    with the same dispatch; `launches_bwd_dq` and `launches_bwd_dkv` count
    their launches.
  * `check_fwd_layout` / `check_bwd_layout`: the kernels' preconditions,
    read from shapes, strides and addresses alone (so the CPU tests reach
    them); `max_kv_len`: the forward kernel's limit on Skv.
  * `FlashAttention`: the torch.autograd.Function (the reference's
    custom VJP): forward `flash_fwd(want_lse=True)`, backward `flash_bwd`.
  * `flash_attention`: the public entry with the reference's arguments. The
    kernels take Sq and Skv as they are, so nothing is padded to 128. With
    grad mode on and an input that requires grad it goes through
    `FlashAttention`; rotary tables are applied outside it and torch
    differentiates them.
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
launches_bwd_dq = 0
launches_bwd_dkv = 0

_SIG = {"flash_attention_fwd_bf16":
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
_BWD_TAIL = [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
_SIG_BWD = {"flash_attention_bwd_dq_bf16": [ctypes.c_void_p] * 12 + _BWD_TAIL,
            "flash_attention_bwd_dkv_bf16":
                [ctypes.c_void_p] * 13 + _BWD_TAIL}

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
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                       vf.float()) * (1.0 / l_safe)
    # a dead row is 0 by a select, as in the kernel: P = 0 times a padded
    # key's V that is NaN or inf would be NaN
    out = torch.where(dead, 0.0, out)
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


def _check_ints(ints, B, Sq, Skv):
    for t, S in zip(ints, (Sq, Skv, Sq, Skv)):
        if (t.shape != (B, S) or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError("segment ids and positions must be contiguous "
                             f"int32 [B, S], got {t.dtype} {tuple(t.shape)}")


# the forward kernel's shared memory (csrc/flash_attention_fwd.cu, Cfg):
# two 64-row Q tiles, K / V rings of 2 / 3 key tiles, a mask ring of 4
# stages of 8 bytes a key, 20 mbarriers, then each warpgroup's listing of
# an item: a fixed head (R_INFO) and 20 bytes a key tile, 16-byte aligned
_SMEM_LIMIT = 232448
_LIST_HEAD = 64 + 4 * 128 + 4 * 128 + 16
_LIST_BYTES_A_TILE = 20


def max_kv_len(head_dim: int) -> int:
    """The longest Skv the forward kernel takes at this head_dim: the most
    key tiles whose listing, beside the rings, fits a block's shared memory
    (the kernel's own formula, Cfg<D>::bytes), times the keys a tile. 90,624
    keys at D 128."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {head_dim} not in "
                         f"{KERNEL_HEAD_DIMS}")
    dp = 32 if head_dim == 24 else head_dim
    bk = 128 if dp >= 64 else 64
    rings = 2 * 64 * dp * 2 + (2 + 3) * bk * dp * 2 + 4 * 8 * bk
    fixed = 1024 + rings + 8 * (2 + 2 * (2 + 4 + 3))
    # 2 regions of (_LIST_HEAD + 20 n) rounded up to 16 bytes
    region = (_SMEM_LIMIT - fixed) // 2 // 16 * 16
    return (region - _LIST_HEAD) // _LIST_BYTES_A_TILE * bk


def check_fwd_layout(q, k, v, ints):
    """Raise unless the forward kernel can take these tensors: bf16 q, k, v
    with head_dim in KERNEL_HEAD_DIMS (24 is padded to 32 inside the
    kernel), shapes that fit, at most `max_kv_len(head_dim)` keys,
    contiguous int32 [B, S] segment ids and positions, one device, and
    heads the kernel copies 16 bytes at a time (`_strides`). Reads shapes,
    strides and addresses only, on any device. Returns the nine (batch,
    row, head) strides of q, k and v."""
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
    if Skv > max_kv_len(D):
        raise ValueError(f"flash kernel: {Skv} keys, above its limit of "
                         f"{max_kv_len(D)} at head_dim {D} (its listing of "
                         f"the key tiles must fit shared memory)")
    _check_ints(ints, B, Sq, Skv)
    if any(t.device != q.device for t in (k, v) + tuple(ints)):
        raise ValueError("q/k/v/segments/positions on different devices")
    return (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"))


def _launch(q, k, v, seg_q, seg_kv, q_positions, kv_positions, causal,
            sm_scale, bounded, want_lse):
    global launches
    ints = (seg_q, seg_kv, q_positions, kv_positions)
    strides = check_fwd_layout(q, k, v, ints)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
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
            *strides, sm_scale * LOG2E, int(causal), int(bounded), stream)
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
    _build.refuse_grad("flash forward (use flash_attention)", q, k, v)
    if q.is_cuda:
        return _launch(q, k, v, seg_q, seg_kv, q_positions, kv_positions,
                       causal, sm_scale, bounded, want_lse)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    out, lse = flash_fwd_ref(q, k, v, seg_q, seg_kv, q_positions,
                             kv_positions, causal=causal, sm_scale=sm_scale)
    return out, (lse if want_lse else None)


def flash_bwd_ref(q, k, v, seg_q, seg_kv, q_positions, kv_positions, out,
                  lse, do, *, causal: bool, sm_scale: float):
    """Plain PyTorch version of the backward kernels. out / lse are the
    forward's (lse natural log, [B, Hq, Sq]); do the gradient of out.
    Returns (dq [B, Sq, Hq, D], dk, dv [B, Skv, Hkv, D]) in the inputs'
    dtypes; a row or key nothing allows gets zeros."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = k.repeat_interleave(group, dim=2) if group > 1 else k
    vf = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) \
        * (sm_scale * LOG2E)
    allowed = _allowed(seg_q, seg_kv, causal, q_positions,
                       kv_positions)[:, None]
    lse2 = (lse.float() * LOG2E)[..., None]
    p = torch.where(allowed, torch.exp2(s - lse2), 0.0)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf.float())
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = dk.reshape(B, Skv, Hkv, group, D).sum(3) * sm_scale
    dv = dv.reshape(B, Skv, Hkv, group, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_bwd_layout(q, k, v, ints, out, lse, do):
    """Raise unless the backward kernels can take these tensors: bf16 q, k,
    v, do and out with head_dim in KERNEL_HEAD_DIMS (24 is padded to 32
    inside the kernels), shapes that fit, contiguous int32 [B, S] segment
    ids and positions, one device, and heads the kernels copy or read 16
    bytes at a time (`_strides`; the dq kernel reads out for delta).
    Reads shapes, strides and addresses only, on any device. Returns the
    fifteen (batch, row, head) strides of q, k, v, do and out."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, do, out)):
        raise TypeError("flash backward kernels take bf16 q/k/v/do/out, got "
                        f"{q.dtype} {k.dtype} {v.dtype} {do.dtype} "
                        f"{out.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash backward kernels: head_dim {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if (k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or Hq % Hkv
            or do.shape != q.shape or out.shape != q.shape
            or lse.shape != (B, Hq, Sq) or min(B, Sq, Skv) == 0):
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do {tuple(do.shape)} lse "
            f"{tuple(lse.shape)}")
    _check_ints(ints, B, Sq, Skv)
    dev = q.device
    if any(t.device != dev for t in (k, v, out, lse, do, *ints)):
        raise ValueError("flash backward inputs on different devices")
    return tuple(x for t, what in ((q, "q"), (k, "k"), (v, "v"), (do, "do"),
                                   (out, "out"))
                 for x in _strides(t, what))


def _launch_bwd(q, k, v, seg_q, seg_kv, q_positions, kv_positions, out, lse,
                do, causal, sm_scale, bounded):
    global launches_bwd_dq, launches_bwd_dkv
    ints = (seg_q, seg_kv, q_positions, kv_positions)
    strides = (ctypes.c_longlong * 15)(
        *check_bwd_layout(q, k, v, ints, out, lse, do))
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    # delta (sum over the head dim of do * out) is computed by the dq
    # kernel, which writes every row of it for the dk / dv kernel; both
    # scale the natural lse to base 2 as they load it
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    lse = lse.float().contiguous()
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Skv, Hkv, D), dtype=k.dtype, device=dev)
    dv = torch.empty((B, Skv, Hkv, D), dtype=v.dtype, device=dev)
    lib = _build.load("flash_attention_bwd", _SIG_BWD)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              *(t.data_ptr() for t in ints))
    dims = (B, Sq, Skv, Hq, Hkv, D, strides, sm_scale * LOG2E, sm_scale,
            int(causal), int(bounded))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_bwd_dq_bf16(*common, dq.data_ptr(), *dims,
                                              stream)
        _build.check(err, "flash_attention_bwd_dq_bf16")
        launches_bwd_dq += 1
        err = lib.flash_attention_bwd_dkv_bf16(*common, dk.data_ptr(),
                                               dv.data_ptr(), *dims, stream)
        _build.check(err, "flash_attention_bwd_dkv_bf16")
        launches_bwd_dkv += 1
    return dq, dk, dv


def flash_bwd(q, k, v, seg_q, seg_kv, q_positions, kv_positions, out, lse,
              do, *, causal: bool, sm_scale: float, bounded: bool = False):
    """Dispatch on the device: the two CUDA kernels for CUDA tensors, the
    plain version for CPU tensors, nothing else. Arguments as
    `flash_fwd`'s, plus its out and lse (want_lse=True) and do, the
    gradient of out. Returns (dq, dk, dv)."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, seg_q, seg_kv, q_positions, kv_positions,
                           out, lse, do.contiguous(), causal, sm_scale,
                           bounded)
    if q.device.type != "cpu":
        raise ValueError(f"no flash backward for device {q.device}")
    return flash_bwd_ref(q, k, v, seg_q, seg_kv, q_positions, kv_positions,
                         out, lse, do, causal=causal, sm_scale=sm_scale)


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward (the reference's `_flash` custom
    VJP). The residuals are q, k, v, the masks, out and lse; the backward
    recomputes the scores from them."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, q_positions, kv_positions,
                causal, sm_scale, bounded):
        out, lse = flash_fwd(q, k, v, seg_q, seg_kv, q_positions,
                             kv_positions, causal=causal, sm_scale=sm_scale,
                             bounded=bounded, want_lse=True)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, q_positions,
                              kv_positions, out, lse)
        ctx.cfg = (causal, sm_scale, bounded)
        return out

    @staticmethod
    def backward(ctx, do):
        causal, sm_scale, bounded = ctx.cfg
        dq, dk, dv = flash_bwd(*ctx.saved_tensors, do, causal=causal,
                               sm_scale=sm_scale, bounded=bounded)
        return dq, dk, dv, None, None, None, None, None, None, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    (`mha_reference`, for CPU tensors only, differentiated by torch).
    Under grad (grad mode on, an input that requires grad) None and
    "rowblock" go through `FlashAttention`: the flash forward, then the
    backward kernels (the packed kernel has no backward; the reference's
    "rowblock" also takes the flash backward). q_positions / kv_positions
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

    grad = _wants_grad(q, k, v)
    if (backend == "rowblock" and not grad and not causal and bounded
            and Hq == Hkv
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
    if grad:
        return FlashAttention.apply(q, k, v, *ints, causal, sm_scale,
                                    bounded)
    return flash_fwd(q, k, v, *ints, causal=causal, sm_scale=sm_scale,
                     bounded=bounded)[0]
