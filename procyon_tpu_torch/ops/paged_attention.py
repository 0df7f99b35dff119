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
  * `chunk_plan`: how the kernel cuts each slot's page walk into chunks,
    from the shapes alone (never from `seq_lens`, which stay on the
    device), and `paged_decode_attention_chunked_ref`: the plain version
    chunk by chunk (a page range each), merged by log-sum-exp in chunk
    order, as the kernel merges its chunks inside the launch.
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
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)
KERNEL_PAGES = (8, 16, 32, 64, 128)
# the chunk plan: as many chunks as keep the grid within BLOCKS_PER_SM
# blocks of (slot, kv head, chunk) an SM, at most MAX_CHUNKS (one
# cluster); two measured fastest at B8, B16 and B80
SMS = _build.SMS
BLOCKS_PER_SM = 2
MAX_CHUNKS = 8

launches = 0

_SIG = {"paged_decode_attention":
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]}


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


def _partial(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads,
             k_scale_pool, v_scale_pool, sm_scale):
    """Attention over the first seq_lens[b] tokens of the pages in
    page_table[b], in f32: (out [B, Hkv, group, D] normalised, 0 where no
    token is live; lse [B, Hkv, group, 1], -1e30 there). p is rounded to
    q's dtype (after the V scale) before P.V, as the kernel rounds it."""
    B, Hq, D = q.shape
    Hkv = n_kv_heads
    group = Hq // Hkv
    page = k_pool.shape[1]
    S = page_table.shape[1] * page
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
    return acc / l_safe, torch.where(dead, NEG_INF, m + torch.log(l_safe))


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, seq_lens, *,
                               n_kv_heads, head_dim, k_scale_pool=None,
                               v_scale_pool=None, sm_scale=None):
    """Plain PyTorch version. Returns (out [B, Hq, D] in q's dtype,
    lse [B, Hq] f32)."""
    _check(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads, head_dim,
           k_scale_pool, v_scale_pool)
    B, Hq, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out, lse = _partial(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads,
                        k_scale_pool, v_scale_pool, sm_scale)
    return out.reshape(B, Hq, D).to(q.dtype), lse.reshape(B, Hq)


def chunk_plan(B: int, n_kv_heads: int, P: int) -> tuple:
    """(chunks, pages a chunk) of the kernel's page walk for B slots, Hkv
    kv heads and a table of P pages: at most BLOCKS_PER_SM blocks an SM in
    all (one chunk at least), at most MAX_CHUNKS chunks. The chunks cover
    the table's P pages exactly, whatever the slots' lengths: those stay
    on the device."""
    want = min(MAX_CHUNKS, P,
               max(1, BLOCKS_PER_SM * SMS // (B * n_kv_heads)))
    per = -(-P // want)
    return -(-P // per), per


def paged_decode_attention_chunked_ref(q, k_pool, v_pool, page_table,
                                       seq_lens, *, n_kv_heads, head_dim,
                                       k_scale_pool=None, v_scale_pool=None,
                                       sm_scale=None, chunk_pages=None):
    """The plain version cut as the kernel cuts it: each chunk of
    `chunk_pages` table entries (chunk_plan's by default) attends over its
    own pages' live tokens, then the chunks merge in chunk order by their
    log-sum-exp, a chunk with nothing live weighing exactly 0. Returns
    (out [B, Hq, D] in q's dtype, lse [B, Hq] f32)."""
    _check(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads, head_dim,
           k_scale_pool, v_scale_pool)
    B, Hq, D = q.shape
    P, page = page_table.shape[1], k_pool.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if chunk_pages is None:
        chunk_pages = chunk_plan(B, n_kv_heads, P)[1]
    parts = []
    for p0 in range(0, P, chunk_pages):
        table = page_table[:, p0:p0 + chunk_pages]
        lens = (seq_lens.long() - p0 * page).clamp(0, table.shape[1] * page)
        parts.append(_partial(q, k_pool, v_pool, table, lens, n_kv_heads,
                              k_scale_pool, v_scale_pool, sm_scale))
    top = parts[0][1]
    for _, lse in parts[1:]:
        top = torch.maximum(top, lse)
    acc = torch.zeros_like(parts[0][0])
    wsum = torch.zeros_like(top)
    for out, lse in parts:
        w = torch.where(lse <= NEG_INF * 0.5, 0.0, torch.exp(lse - top))
        acc = acc + w * out
        wsum = wsum + w
    dead = wsum == 0.0
    w_safe = torch.where(dead, 1.0, wsum)
    out = (acc / w_safe).reshape(B, Hq, D).to(q.dtype)
    lse = torch.where(dead, NEG_INF, top + torch.log(w_safe))
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
    if D not in KERNEL_HEAD_DIMS or group not in KERNEL_GROUPS:
        raise ValueError(
            f"paged attention kernel: head_dim {D} / group {group} not in "
            f"{KERNEL_HEAD_DIMS} x {KERNEL_GROUPS}")
    if page not in KERNEL_PAGES:
        raise ValueError(f"paged attention kernel: page_size {page} not in "
                         f"{KERNEL_PAGES}")
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
    if B == 0 or P == 0:
        raise ValueError("paged attention kernel: empty batch or table")
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=dev)
    chunk_pages = chunk_plan(B, n_kv_heads, P)[1]
    lib = _build.load("paged_attention", _SIG)
    with torch.cuda.device(dev):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale_pool.data_ptr() if quantized else None,
            v_scale_pool.data_ptr() if quantized else None,
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, n_kv_heads, D, page, P,
            k_pool.shape[0], int(quantized), chunk_pages, float(sm_scale),
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
    _build.refuse_grad("paged attention", q, k_pool, v_pool)
    if q.is_cuda:
        return _launch(q, k_pool, v_pool, page_table, seq_lens, n_kv_heads,
                       head_dim, k_scale_pool, v_scale_pool, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no paged attention for device {q.device}")
    return paged_decode_attention_ref(
        q, k_pool, v_pool, page_table, seq_lens, n_kv_heads=n_kv_heads,
        head_dim=head_dim, k_scale_pool=k_scale_pool,
        v_scale_pool=v_scale_pool, sm_scale=sm_scale)
