"""Fused int4 unpack + matmul for decode-shaped calls (counterpart of
procyon_tpu/ops/int4_matmul.py::qmatvec4).

A decode step streams every decoder weight once, so it is bound by the
bytes of the weights. Packed int4 halves the bytes of int8 only if the
packed form is what crosses device memory: `x @ dequantize4(qw)` writes the
dequantized weight out and reads it back. `qmatvec4` reads the packed
`[k/2, n]` nibbles, unpacks them in registers, multiplies group by group
with f32 accumulation and applies each group's f32 scale after its dot.

  * `qmatvec4_ref`: the plain PyTorch version, the kernel's arithmetic step
    by step (per group: unpack, dot in f32, scale, add). The CPU tests use
    it, and CPU tensors take it.
  * `qmatvec4`: the one wrapper. On a CUDA tensor it launches the
    hand-written kernel in csrc/int4_matmul.cu or raises; on a CPU tensor
    it runs the plain version. `launches` counts kernel launches (one a
    call: the k-split's second pass belongs to its call).

`x @ dequantize4(qw)` is another function numerically (it rounds q * s to
x's dtype before the product); ops/quant.qmatmul4 keeps it for calls of
more than 256 rows, as the reference does.

The reference's two kernel variants ("affine" and "dq", chosen by
PROCYON_INT4_IMPL) differ in how they avoid an int8 vector shift the TPU
lacks; they compute this same function, and one kernel stands for both.
"""

import ctypes
import threading

import torch

from procyon_tpu_torch.ops import _build

launches = 0

# the grid: one warp per (32 columns, k slice, row block), eight warps a
# block. The wrapper splits k until about this many warps exist, so that
# narrow weights (n = 1024 or 4096) still spread over the card's 132 SMs
# with two or three blocks each; 8, 16 and 24 warps an SM were timed on the
# H100 at the Llama-3-8B shapes, 24 was the fastest (PERF.md)
TARGET_WARPS = 132 * 24
MAX_ROWS = 256

_SIG = {"int4_matmul":
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


def _shapes(x, qw):
    p, s = qw["p"], qw["s"]
    if p.dim() != 2 or s.dim() != 3 or s.shape[1] != 1:
        raise ValueError(f"qmatvec4 takes p [k/2, n] and s [G, 1, n], got "
                         f"{tuple(p.shape)} {tuple(s.shape)}")
    k2, n = p.shape
    k, G = 2 * k2, s.shape[0]
    if x.shape[-1] != k or s.shape[2] != n or G == 0 or k % G:
        raise ValueError(f"qmatvec4: x {tuple(x.shape)} against p "
                         f"{tuple(p.shape)}, s {tuple(s.shape)}")
    group = k // G
    if k2 % group:
        raise ValueError(f"qmatvec4: groups of {group} straddle the nibble "
                         f"halves of k = {k}")
    if p.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"qmatvec4 takes int8 p and f32 s, got {p.dtype} "
                        f"{s.dtype}")
    return k, n, G, group


def qmatvec4_ref(x, qw):
    """Plain PyTorch version. x [..., k]; qw {"p": int8 [k/2, n], "s": f32
    [G, 1, n]} (ops/quant.quantize4) -> [..., n] in x's dtype. Per group:
    the nibbles unpacked to integers, the dot with x in f32, the group's
    f32 scale applied to the dot, and the groups added in f32."""
    from procyon_tpu_torch.ops.quant import unpack4
    k, n, G, group = _shapes(x, qw)
    q = unpack4(qw["p"]).reshape(G, group, n).float()
    xg = x.reshape(-1, G, group).float()
    dots = torch.einsum("rgk,gkn->grn", xg, q)              # [G, rows, n]
    out = (dots * qw["s"].reshape(G, 1, n)).sum(0)
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def k_split(rows: int, n: int, packed_groups: int, rows_per_warp: int) -> int:
    """How many slices of whole groups the kernel's grid cuts k into."""
    mblocks = -(-rows // rows_per_warp)
    want = -(-TARGET_WARPS // ((n // 32) * mblocks))
    return max(1, min(packed_groups, want))


def _raw_stream(dev) -> int:
    """The current stream's handle on `dev`, without building a Stream
    object: the wrapper runs 225 times a forward."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


_scratch = {}       # (device index, stream) -> f32 buffer of the k slices
# ctypes releases the interpreter lock during the call: two threads on one
# stream must not interleave their two passes over the shared scratch
_scratch_lock = threading.Lock()


def _partials(dev, stream: int, numel: int) -> torch.Tensor:
    """The f32 scratch of a k-split launch. Launches on one stream run in
    order, so they share one buffer a stream, grown when a shape needs
    more; a launch's second pass has read it before the next one writes."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        buf = _scratch[key] = torch.empty(numel, dtype=torch.float32,
                                          device=dev)
    return buf


def _launch(x, qw):
    global launches
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x, qw)
    k, n, G, group = _shapes(x, qw)
    p, s = qw["p"], qw["s"]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int4 matmul kernel takes bf16 x, got {x.dtype}")
    if p.device != dev or s.device != dev:
        raise ValueError("int4 matmul kernel: x, p and s on different "
                         "devices")
    rows = x.numel() // k
    if rows == 0 or rows > MAX_ROWS:
        raise ValueError(f"int4 matmul kernel takes 1..{MAX_ROWS} rows, got "
                         f"{rows}")
    if n % 128 or group % 16:
        raise ValueError(f"int4 matmul kernel: n = {n} must be a multiple "
                         f"of 128 and the group size {group} of 16")
    # the kernel copies x in 16-byte pieces, row by row
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        x2, ldx = x, k
    else:
        x2 = x.reshape(rows, k)
        if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
            x2 = x2.contiguous()
        ldx = x2.stride(0)
    ldp, lds = p.stride(0), s.stride(0)
    if p.stride(1) != 1 or ldp % 4 or p.data_ptr() % 4 \
            or s.stride(2) != 1 or lds % 4 or s.data_ptr() % 16:
        raise ValueError(
            "int4 matmul kernel reads p in 4-byte and s in 16-byte words "
            f"along n: strides {p.stride()} / {s.stride()} do not fit")
    rows_per_warp = 16 if rows <= 16 else 32
    ksplit = k_split(rows, n, G // 2, rows_per_warp)
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=dev)
    lib = _build.load("int4_matmul", _SIG)
    stream = _raw_stream(dev)
    args = (rows, k, n, group, ldx, ldp, lds, ksplit, rows_per_warp, stream)
    ptrs = (x2.data_ptr(), p.data_ptr(), s.data_ptr(), out.data_ptr())
    if ksplit > 1:
        with _scratch_lock:
            part = _partials(dev, stream, ksplit * rows * n)
            err = lib.int4_matmul(*ptrs, part.data_ptr(), *args)
    else:
        err = lib.int4_matmul(*ptrs, None, *args)
    _build.check(err, "int4_matmul")
    launches += 1
    return out


def qmatvec4(x, qw):
    """x [..., k] @ split-half-packed int4 weights -> [..., n] in x's dtype.

    qw: {"p": int8 [k/2, n], "s": f32 [G, 1, n]} (ops/quant.quantize4); a
    layer's slice of a stacked leaf is taken as it is. Meant for
    decode-shaped x: at most 256 rows in all. Dispatch on the device: the
    CUDA kernel for CUDA tensors (bf16 x), the plain version for CPU
    tensors, nothing else."""
    if x.is_cuda:
        return _launch(x, qw)
    if x.device.type != "cpu":
        raise ValueError(f"no int4 matmul for device {x.device}")
    return qmatvec4_ref(x, qw)
