"""Paged decode attention (counterpart of procyon_tpu/ops/
paged_attention.py::paged_decode_attention_fullpage).

One-token attention that walks the page table of the serving KV pool
(inference/kv_pool.py): for each slot, softmax(q . K^T / sqrt(D)) V over
the first `seq_lens[b]` tokens of the pages its table row lists. Pages are
read once, never gathered into a dense [B, max_ctx, Hkv*D] context copy.

Numerics, as the reference kernel: f32 scores and accumulation; the
unnormalised probabilities are cast to the compute dtype (q's) before P.V
while l sums the unrounded ones; out = acc / l, lse = m + log l; a slot
with `seq_lens == 0` gives out 0 and lse -1e30. On int8 pools the K scale
multiplies the score row and the V scale multiplies the unnormalised P
before the cast.

The reference passes block-diagonal queries [B, Hq, Hkv*D] and returns
block-diagonal output lanes, which is the TPU's blocking; here q and out
are [B, Hq, D] and a query head h reads kv head h // (Hq // Hkv).

  * `paged_decode_attention_ref`: the plain PyTorch version (gathers the
    pages, one softmax over the whole context).
  * `paged_decode_attention_fullpage`: the one wrapper. On a CUDA tensor it
    launches the hand-written kernel in csrc/paged_attention.cu (bf16 q;
    bf16 pools, or int8 pools with f32 scales) or raises; on a CPU tensor it
    runs the plain version. `launches` counts kernel launches.
"""

import ctypes
import math

import torch

from procyon_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL_THREADS = 128
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)

launches = 0

_SIG = {"paged_decode_attention":
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]}


def _check(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads, head_dim,
           k_scale_pool, v_scale_pool):
    B, Hq, D = q.shape
    if D != head_dim or Hq % n_kv_heads:
        raise ValueError(f"q {tuple(q.shape)} does not fit {n_kv_heads} kv "
                         f"heads of {head_dim}")
    if k_pool.dim() != 3 or k_pool.shape[2] != n_kv_heads * head_dim \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"are not [n_pages, page, {n_kv_heads * head_dim}]")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or seq_lens.shape != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not fit B={B}")
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("k_scale_pool and v_scale_pool go together")
    if k_scale_pool is not None:
        want = (*k_pool.shape[:2], n_kv_heads)
        if tuple(k_scale_pool.shape) != want \
                or tuple(v_scale_pool.shape) != want:
            raise ValueError(f"scale pools must be {want}")


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, seq_lens, *,
                               n_kv_heads, head_dim, k_scale_pool=None,
                               v_scale_pool=None, sm_scale=None):
    """Plain PyTorch version. Returns (out [B, Hq, D] in q's dtype,
    lse [B, Hq] f32)."""
    _check(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads, head_dim,
           k_scale_pool, v_scale_pool)
    B, Hq, D = q.shape
    Hkv = n_kv_heads
    group = Hq // Hkv
    page = k_pool.shape[1]
    S = page_table.shape[1] * page
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    table = page_table.long()
    dt = q.dtype
    kc = k_pool[table].reshape(B, S, Hkv, D).to(dt).float()
    vc = v_pool[table].reshape(B, S, Hkv, D).to(dt).float()
    qh = q.reshape(B, Hkv, group, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, kc) * sm_scale
    if k_scale_pool is not None:
        ks = k_scale_pool[table].reshape(B, S, Hkv)
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    live = torch.arange(S, device=q.device)[None, :] \
        < seq_lens.long()[:, None]                              # [B, S]
    live = live[:, None, None, :]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    safe_m = torch.where(m <= NEG_INF * 0.5, 0.0, m)
    p = torch.where(live, torch.exp(s - safe_m), 0.0)
    l = p.sum(-1, keepdim=True)
    if v_scale_pool is not None:
        vs = v_scale_pool[table].reshape(B, S, Hkv)
        p = p * vs.permute(0, 2, 1)[:, :, None, :]
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(dt).float(), vc)
    dead = l == 0.0
    l_safe = torch.where(dead, 1.0, l)
    out = (acc / l_safe).reshape(B, Hq, D).to(dt)
    lse = torch.where(dead, NEG_INF, m + torch.log(l_safe))
    return out, lse.reshape(B, Hq)


def _launch(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads, head_dim,
            k_scale_pool, v_scale_pool, sm_scale):
    global launches
    B, Hq, D = q.shape
    group = Hq // n_kv_heads
    page, P = k_pool.shape[1], page_table.shape[1]
    quantized = k_scale_pool is not None
    pool_dtype = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(
            "paged attention kernel takes bf16 q and bf16 pools, or int8 "
            f"pools with scales; got {q.dtype} {k_pool.dtype} "
            f"{v_pool.dtype}, scales {'given' if quantized else 'absent'}")
    if quantized and (k_scale_pool.dtype != torch.float32
                      or v_scale_pool.dtype != torch.float32):
        raise TypeError("paged attention kernel takes f32 scale pools")
    if D not in KERNEL_HEAD_DIMS or group not in KERNEL_GROUPS \
            or (group * D) % KERNEL_THREADS:
        raise ValueError(
            f"paged attention kernel: head_dim {D} / group {group} not in "
            f"{KERNEL_HEAD_DIMS} x {KERNEL_GROUPS} with group * head_dim a "
            f"multiple of {KERNEL_THREADS}")
    # a block's threads split a page's tokens and, when the page is shorter
    # than the block, each token's head_dim into 16-byte pieces
    split = KERNEL_THREADS // page if page and KERNEL_THREADS % page == 0 \
        else 0
    if not split or (D * k_pool.element_size()) % (16 * split):
        raise ValueError(
            f"paged attention kernel: page_size {page} with head_dim {D} in "
            f"{k_pool.dtype} does not divide over {KERNEL_THREADS} threads "
            "in 16-byte pieces")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged attention kernel takes int32 page_table and "
                        f"seq_lens, got {page_table.dtype} {seq_lens.dtype}")
    tensors = [q, k_pool, v_pool, page_table, seq_lens]
    if quantized:
        tensors += [k_scale_pool, v_scale_pool]
    dev = q.device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("paged attention kernel needs contiguous "
                             "tensors on one device")
    if B == 0:
        raise ValueError("paged attention kernel: empty batch")
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=dev)
    lib = _build.load("paged_attention", _SIG)
    with torch.cuda.device(dev):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale_pool.data_ptr() if quantized else None,
            v_scale_pool.data_ptr() if quantized else None,
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, n_kv_heads, D, page, P,
            k_pool.shape[0], int(quantized), float(sm_scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_decode_attention")
    launches += 1
    return out, lse


def paged_decode_attention_fullpage(q, k_pool, v_pool, page_table,
                                    seq_lens, *, n_kv_heads, head_dim,
                                    k_scale_pool=None, v_scale_pool=None,
                                    sm_scale=None):
    """One-token attention over paged KV.

    q          [B, Hq, D]
    k_pool     [n_pages, page_size, Hkv*D] (the flat layer-major pool; pass
               page_table pre-offset by layer * pages_per_layer)
    v_pool     same
    page_table [B, P] int32 pool page ids
    seq_lens   [B] int32 live tokens per slot
    k_scale_pool / v_scale_pool: [n_pages, page_size, Hkv] f32 for int8
               pools; k_pool / v_pool then hold int8 rows
    -> out [B, Hq, D], lse [B, Hq] f32

    Dispatch on the device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, nothing else."""
    _check(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads, head_dim,
           k_scale_pool, v_scale_pool)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    if q.is_cuda:
        return _launch(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads,
                       head_dim, k_scale_pool, v_scale_pool, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no paged attention for device {q.device}")
    return paged_decode_attention_ref(
        q, k_pool, v_pool, page_table, seq_lens, n_kv_heads=n_kv_heads,
        head_dim=head_dim, k_scale_pool=k_scale_pool,
        v_scale_pool=v_scale_pool, sm_scale=sm_scale)
