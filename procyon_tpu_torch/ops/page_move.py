"""In-place page copy inside the paged KV pool (counterpart of
procyon_tpu/ops/page_move.py::move_pages_direct).

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

Both update `pool_arr` in place and return it.

The staged variant `move_pages` (sources that are also destinations) is
not ported yet (ROADMAP.md, queue 2, row 11): no path of the reference
runs it.
"""

import ctypes

import torch

from procyon_tpu_torch.ops import _build

launches = 0

_SIG = {"page_move_direct":
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]}


def _check_indices(pool_arr, src, dst):
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError(f"src / dst must be [M] alike, got "
                         f"{tuple(src.shape)} {tuple(dst.shape)}")
    if src.device != pool_arr.device or dst.device != pool_arr.device:
        raise ValueError("pool, src and dst on different devices")


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
    if torch.unique(dst).numel() != dst.numel():
        raise ValueError("page move: a destination row repeats")
    n = pool_arr.shape[0]
    if min(int(src.min()), int(dst.min())) < 0 \
            or max(int(src.max()), int(dst.max())) >= n:
        raise ValueError(f"page move: a row is outside [0, {n})")
    return pool_arr.index_copy_(0, dst, pool_arr.index_select(0, src))


def _launch(pool_arr, src, dst):
    global launches
    if not pool_arr.is_contiguous():
        raise ValueError("page move kernel needs a contiguous pool")
    if src.dtype != torch.int32 or dst.dtype != torch.int32 \
            or not src.is_contiguous() or not dst.is_contiguous():
        raise TypeError("page move kernel takes contiguous int32 src / dst, "
                        f"got {src.dtype} {dst.dtype}")
    n_moves = src.numel()
    if n_moves == 0 or pool_arr.shape[0] == 0:
        return pool_arr
    row_bytes = pool_arr[0].numel() * pool_arr.element_size()
    if row_bytes % 16 or pool_arr.data_ptr() % 16:
        raise ValueError(f"page move kernel copies 16 bytes a thread: a row "
                         f"of {row_bytes} bytes at {pool_arr.data_ptr():#x} "
                         "does not fit")
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
