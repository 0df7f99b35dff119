"""In-place page copies inside the paged KV pool (counterparts of
procyon_tpu/ops/page_move.py::move_pages_direct and ::move_pages).

The beam copy-on-write (inference/paged_beam.py) copies each beam slot's
current partial page onto the slot's private page on every parent reorder:
`pool[dst[i]] = pool[src[i]]` for a list of page rows, every other row
untouched. It is right only when the src and dst sets are disjoint (the
beam path's ping-pong private pages guarantee it); dst rows are distinct,
src rows may repeat.

  * `move_pages_direct_ref`: the plain PyTorch version (gather, then
    `index_copy_`). It checks the disjointness it relies on, so every CPU
    beam test is a test of the page plan.
  * `move_pages_direct`: the one wrapper. On a CUDA tensor it launches the
    hand-written kernel in csrc/page_move.cu or raises; on a CPU tensor it
    runs the plain version. `launches` counts kernel launches. The kernel
    copies bytes, so bf16 pages, int8 pages and the f32 scale slabs of an
    int8 pool go through it alike. It does not check disjointness: that
    would be a read of the device by the host in every beam step.

The staged move, `pool[dst[i]] = old pool[src[i]]` for any move list
(chains, swaps and cycles: a row may be a source and a destination):

  * `move_pages_ref`: the plain version (`index_select` copies every
    source before `index_copy_` writes a destination). It checks that
    destinations are distinct and rows in range, nothing else.
  * `staging_plan`: the plan the kernel builds on the device, stated in
    plain code: the rows that are a source and a destination (some move
    overwrites them before another reads them) are copied aside first,
    and each move reads its source's staged copy or, for every other
    source, the pool, which no move writes there.
  * `move_pages`: the wrapper. On a CUDA tensor it launches the kernel in
    csrc/page_move.cu once: the plan, then the staged rows copied into a
    scratch of `STAGE_BYTES` (in column slabs where they do not fit it),
    then one pass of moves, each distinct source read once for all
    its destinations. `launches_staged` counts staged moves.

All update `pool_arr` in place and return it.
"""

import ctypes

import torch

from procyon_tpu_torch.ops import _build

launches = 0
launches_staged = 0

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIG = {"page_move_direct": [_P] * 3 + [_LL, _I, _P],
        "page_move_staged": [_P] * 3 + [_LL, _I, _I, _P, _P, _LL, _P]}
# the staged move's scratch: the staged rows where they fit, else column
# slabs of them (the host does not know their number without a read of the
# device); never less than 128 bytes a move or more than every move's row
STAGE_BYTES = 16 << 20
# the kernel's plan: a head of 4 int32, then [2 rows + 4 moves]
_PLAN_HEAD = 4


def _check_indices(pool_arr, src, dst):
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError(f"src / dst must be [M] alike, got "
                         f"{tuple(src.shape)} {tuple(dst.shape)}")
    if src.device != pool_arr.device or dst.device != pool_arr.device:
        raise ValueError("pool, src and dst on different devices")


def _check_plan(pool_arr, src, dst):
    """Distinct destinations, every row in range (reads the indices)."""
    if torch.unique(dst).numel() != dst.numel():
        raise ValueError("page move: a destination row repeats")
    n = pool_arr.shape[0]
    if min(int(src.min()), int(dst.min())) < 0 \
            or max(int(src.max()), int(dst.max())) >= n:
        raise ValueError(f"page move: a row is outside [0, {n})")


def move_pages_direct_ref(pool_arr, src, dst):
    """Plain PyTorch version. pool_arr [N, ...]; src / dst [M] integer page
    rows. Updates pool_arr in place and returns it. Raises when a source is
    also a destination, a destination repeats, or a row is out of range."""
    _check_indices(pool_arr, src, dst)
    src, dst = src.long(), dst.long()
    if src.numel() == 0:
        return pool_arr
    if torch.isin(src, dst).any():
        raise ValueError("page move: a source row is also a destination")
    _check_plan(pool_arr, src, dst)
    return pool_arr.index_copy_(0, dst, pool_arr.index_select(0, src))


def move_pages_ref(pool_arr, src, dst):
    """Plain PyTorch version of the staged move: every dst[i] receives the
    old pool[src[i]], also where a row is both a source and a destination.
    Updates pool_arr in place and returns it. Raises when a destination
    repeats or a row is out of range."""
    _check_indices(pool_arr, src, dst)
    src, dst = src.long(), dst.long()
    if src.numel() == 0:
        return pool_arr
    _check_plan(pool_arr, src, dst)
    return pool_arr.index_copy_(0, dst, pool_arr.index_select(0, src))


def _row_bytes(pool_arr, src, dst):
    """Bytes of one row after the checks every launch needs; None when
    there is nothing to move."""
    if not pool_arr.is_contiguous():
        raise ValueError("page move kernel needs a contiguous pool")
    if src.dtype != torch.int32 or dst.dtype != torch.int32 \
            or not src.is_contiguous() or not dst.is_contiguous():
        raise TypeError("page move kernel takes contiguous int32 src / dst, "
                        f"got {src.dtype} {dst.dtype}")
    if src.numel() == 0 or pool_arr.shape[0] == 0:
        return None
    row_bytes = pool_arr[0].numel() * pool_arr.element_size()
    if row_bytes % 16 or pool_arr.data_ptr() % 16:
        raise ValueError(f"page move kernel copies 16 bytes a thread: a row "
                         f"of {row_bytes} bytes at {pool_arr.data_ptr():#x} "
                         "does not fit")
    return row_bytes


def _launch(pool_arr, src, dst):
    global launches
    row_bytes = _row_bytes(pool_arr, src, dst)
    if row_bytes is None:
        return pool_arr
    n_moves = src.numel()
    lib = _build.load("page_move", _SIG)
    dev = pool_arr.device
    with torch.cuda.device(dev):
        err = lib.page_move_direct(
            pool_arr.data_ptr(), src.data_ptr(), dst.data_ptr(), row_bytes,
            n_moves, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "page_move_direct")
    launches += 1
    return pool_arr


def move_pages_direct(pool_arr, src, dst):
    """In place `pool_arr[dst[i]] = pool_arr[src[i]]`, src and dst disjoint.
    pool_arr [N, ...] of any dtype; src / dst [M] page rows (int32 on a
    CUDA device). Dispatch on the device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, nothing else. Returns pool_arr."""
    _check_indices(pool_arr, src, dst)
    _build.refuse_grad("page move", pool_arr)
    if pool_arr.is_cuda:
        return _launch(pool_arr, src, dst)
    if pool_arr.device.type != "cpu":
        raise ValueError(f"no page move for device {pool_arr.device}")
    return move_pages_direct_ref(pool_arr, src, dst)


def staging_plan(src, dst, n_rows):
    """The staged move's plan for src / dst [M] (distinct destinations) over
    n_rows rows: (staged, slot). `staged` [K] holds the rows that are a
    source and a destination, each once, in increasing order: they are
    copied aside before any destination is written. `slot` [M] says where
    move i reads: its source's index in `staged`, or -1 for the pool (a row
    no move writes). The kernel builds the same sets on the device
    (mark[dst[i]] = i; a source is staged where mark[src] >= 0), numbering
    its slots in its own order."""
    src, dst = src.long(), dst.long()
    mark = torch.full((n_rows,), -1, dtype=torch.long, device=src.device)
    mark[dst] = torch.arange(dst.numel(), device=src.device)
    overwritten = mark[src] >= 0
    staged = torch.unique(src[overwritten])
    slot = torch.full_like(src, -1)
    slot[overwritten] = torch.searchsorted(staged, src[overwritten])
    return staged, slot


def _launch_staged(pool_arr, src, dst):
    global launches_staged
    row_bytes = _row_bytes(pool_arr, src, dst)
    if row_bytes is None:
        return pool_arr
    n_moves, n_rows = src.numel(), pool_arr.shape[0]
    dev = pool_arr.device
    plan = torch.empty(_PLAN_HEAD + 2 * n_rows + 4 * n_moves,
                       dtype=torch.int32, device=dev)
    scratch = torch.empty(min(n_moves * row_bytes,
                              max(STAGE_BYTES, 128 * n_moves)),
                          dtype=torch.uint8, device=dev)
    lib = _build.load("page_move", _SIG)
    with torch.cuda.device(dev):
        _build.check(lib.page_move_staged(
            pool_arr.data_ptr(), src.data_ptr(), dst.data_ptr(), row_bytes,
            n_moves, n_rows, plan.data_ptr(), scratch.data_ptr(),
            scratch.numel(), torch.cuda.current_stream(dev).cuda_stream),
            "page_move_staged")
    launches_staged += 1
    return pool_arr


def move_pages(pool_arr, src, dst):
    """In place `pool_arr[dst[i]] = old pool_arr[src[i]]` for any move list
    with distinct destinations (a row may be both a source and a
    destination). pool_arr [N, ...] of any dtype; src / dst [M] page rows
    (int32 on a CUDA device). The CUDA kernel (the staged rows copied
    aside, then every move) for CUDA tensors, the plain version for CPU
    tensors, nothing else. Returns pool_arr."""
    _check_indices(pool_arr, src, dst)
    _build.refuse_grad("page move", pool_arr)
    if pool_arr.is_cuda:
        return _launch_staged(pool_arr, src, dst)
    if pool_arr.device.type != "cpu":
        raise ValueError(f"no page move for device {pool_arr.device}")
    return move_pages_ref(pool_arr, src, dst)
