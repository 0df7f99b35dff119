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
    it runs the plain version. `launches` counts kernel launches: one a
    call, the k slices being added inside the launch.
  * `plan`: the kernel's grid for a call's shapes (row tile, column tile,
    k slices), pure Python.

`x @ dequantize4(qw)` is another function numerically (it rounds q * s to
x's dtype before the product); ops/quant.qmatmul4 keeps it for calls of
more than 256 rows, as the reference does.

The reference's two kernel variants ("affine" and "dq", chosen by
PROCYON_INT4_IMPL) differ in how they avoid an int8 vector shift the TPU
lacks; they compute this same function, and one kernel stands for both.
"""

import ctypes
import functools

import torch

from procyon_tpu_torch.ops import _build

launches = 0

# the grid: a block per (row tile, column tile, k slice); the k slices of a
# tile are one thread-block cluster and add their partials inside the
# launch. Measured on the H100 at the Llama-3-8B shapes (PERF.md):
# fewer slices stream faster (the weights' rows are read in fewer places
# at once), uneven ones lose, 256-column tiles never won; the plan aims at
# BLOCKS_PER_SM blocks an SM with at most MAX_SLICES slices (above 8 a
# cluster is non-portable; the H100 takes 16)
SMS = _build.SMS
BLOCKS_PER_SM = 2
MAX_SLICES = 16
COL_TILES = (128, 64)
MAX_ROWS = 256

_SIG = {"int4_matmul":
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


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


@functools.lru_cache(maxsize=256)
def plan(rows: int, n: int, packed_groups: int,
         blocks_per_sm: int = BLOCKS_PER_SM) -> tuple:
    """(row tile, column tile, k slices) of the kernel's grid for `rows`
    rows of x against n columns with `packed_groups` groups in each nibble
    half of k, from the shapes alone. 16-row tiles up to 16 rows, 32-row
    ones above; the widest column tile whose tiles, cut into at most
    MAX_SLICES slices, give every SM a block (else 64 columns); slices a
    divisor of the groups (even slices), the most that stays within
    `blocks_per_sm` blocks an SM, or else the fewest that give every SM a
    block."""
    row_tile = 16 if rows <= 16 else 32
    mblocks = -(-rows // row_tile)
    most = min(MAX_SLICES, packed_groups)
    for col_tile in COL_TILES:
        if n % col_tile == 0 and (n // col_tile) * mblocks * most >= SMS:
            break
    tiles = (n // col_tile) * mblocks
    even = [d for d in range(1, most + 1) if packed_groups % d == 0]
    slices = max(d for d in even
                 if d == 1 or tiles * d <= blocks_per_sm * SMS)
    if tiles * slices < SMS:
        slices = min([d for d in even if tiles * d >= SMS] or [even[-1]])
    return row_tile, col_tile, slices


def _raw_stream(dev) -> int:
    """The current stream's handle on `dev`, without building a Stream
    object: the wrapper runs 225 times a forward."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


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
    # the kernel's TMA copies read x, p and s through tensor maps: 16-byte
    # aligned bases and row strides
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        x2, ldx = x, k
    else:
        x2 = x.reshape(rows, k)
        if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
            x2 = x2.contiguous()
        ldx = x2.stride(0)
    ldp, lds = p.stride(0), s.stride(0)
    if p.stride(1) != 1 or ldp % 16 or p.data_ptr() % 16 \
            or s.stride(2) != 1 or lds % 4 or s.data_ptr() % 16:
        raise ValueError(
            "int4 matmul kernel reads p and s through TMA: 16-byte aligned "
            f"rows needed, strides {p.stride()} / {s.stride()} do not fit")
    row_tile, col_tile, slices = plan(rows, n, G // 2)
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=dev)
    lib = _build.load("int4_matmul", _SIG)
    err = lib.int4_matmul(x2.data_ptr(), p.data_ptr(), s.data_ptr(),
                          out.data_ptr(), rows, k, n, group, ldx, ldp, lds,
                          row_tile, col_tile, slices, _raw_stream(dev))
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
    _build.refuse_grad("int4 matmul", x)
    if x.is_cuda:
        return _launch(x, qw)
    if x.device.type != "cpu":
        raise ValueError(f"no int4 matmul for device {x.device}")
    return qmatvec4_ref(x, qw)
