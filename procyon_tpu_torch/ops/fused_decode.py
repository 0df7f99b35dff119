"""Fused decode MLP with int8 weights (counterpart of
scripts/probe_fused_decode.py::fused_decode_mlp, the reference's Pallas
probe of one decode layer's MLP at a few rows).

    out = x + (silu(g) * u) @ Wd * sd,   g = xn @ Wg * sg,  u = xn @ Wu * su,
    xn = rms_norm(x, nw)

with int8 leaves {"q": int8 [in, out], "s": f32 [1, out]} in the JAX
layout: gate and up [d, I], down [I, d]. Numerics as the reference kernel:
RMSNorm statistics in f32, xn cast to x's dtype; the products of xn with
the int8 weights cast to x's dtype (exact) summed in f32 and then scaled
per column; a = g * sigmoid(g) * u cast to x's dtype; the down product
summed in f32 over all of I; `x + acc * sd` in f32, then one cast.

  * `fused_decode_mlp_ref`: the plain PyTorch version (f32 products of the
    cast operands).
  * `fused_decode_mlp`: the wrapper. On a CUDA tensor (bf16 x of 1 to 16
    rows) it launches the hand-written kernels in csrc/fused_decode_mlp.cu
    (gate / up, then down: each weight byte read once, through TMA, by
    column tiles cut into k slices whose partials are added inside the
    launch) or raises; on a CPU tensor it runs the plain version; any other
    device raises. `launches` counts calls that launched the pair.
  * `plan`: the k slices of each launch for a call's shapes, pure Python.
"""

import ctypes
import functools

import torch

from procyon_tpu_torch.ops import _build

launches = 0

MAX_ROWS = 16
# the kernels' grid: column tiles of COL_TILE columns (a 128-byte row of a
# weight box), each cut into k slices of whole STAGE_ROWS-row ring stages,
# the slices of a tile one thread-block cluster (at most MAX_SLICES; above 8
# non-portable, which the H100 takes). The kernels' shared memory allows
# two blocks an SM, but a cluster has to fit in one GPC of 16 to 18 SMs:
# measured on the H100, the down launch at 8 slices (256 blocks in
# clusters of 8) ran clearly slower than at 7 (224 blocks), its clusters
# not all resident at once. So the plan keeps to FILL_BLOCKS (224, 85% of
# two blocks an SM).
SMS = _build.SMS
COL_TILE = 128
STAGE_ROWS = 64
MAX_SLICES = 16
BLOCKS_PER_SM = 2
FILL_BLOCKS = int(0.85 * BLOCKS_PER_SM * SMS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"fused_decode_mlp_bf16": [_P] * 10 + [_I] * 3
        + [ctypes.c_float, _I, _I, _I, _P]}


def _slices(tiles: int, stages: int) -> int:
    """k slices of `stages` ring stages for `tiles` column tiles: a divisor
    of the stages (even slices), the most within FILL_BLOCKS blocks, or
    else the fewest that give every SM a block (else the most there
    are)."""
    even = [s for s in range(1, min(MAX_SLICES, stages) + 1)
            if stages % s == 0]
    within = [s for s in even if tiles * s <= FILL_BLOCKS]
    slices = max(within) if within else 1
    if tiles * slices < SMS:
        slices = min([s for s in even if tiles * s >= SMS] or [even[-1]])
    return slices


@functools.lru_cache(maxsize=64)
def plan(d: int, I: int) -> tuple:
    """(gate / up slices, down slices) of the kernels' grids at width d and
    hidden width I: the gate / up launch cuts d for I / COL_TILE column
    tiles, the down launch cuts I for d / COL_TILE (at Llama-3-8B, d 4096
    and I 14336: 112 x 2 and 32 x 7 blocks)."""
    return (_slices(I // COL_TILE, d // STAGE_ROWS),
            _slices(d // COL_TILE, I // STAGE_ROWS))


def _product(a, qw):
    """a @ q (q cast to a's dtype, exact for int8) summed in f32, times
    the column scale."""
    q = qw["q"].to(a.dtype)
    return (a.float() @ q.float()) * qw["s"].float().reshape(1, -1)


def fused_decode_mlp_ref(x, nw, wg, wu, wd, *, eps: float = 1e-5):
    """Plain PyTorch version. x [M, d]; nw [d]; wg / wu {"q": int8 [d, I],
    "s": [1, I]}; wd {"q": int8 [I, d], "s": [1, d]}. Returns [M, d] in
    x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    xn = (xf * torch.rsqrt(ms + eps) * nw.float()).to(x.dtype)
    g = _product(xn, wg)
    u = _product(xn, wu)
    a = (g * torch.sigmoid(g) * u).to(x.dtype)
    acc = a.float() @ wd["q"].to(x.dtype).float()
    return (xf + acc * wd["s"].float().reshape(1, -1)).to(x.dtype)


def _leaf(qw, rows, cols, dev, what):
    q, s = qw["q"], qw["s"].reshape(-1).float().contiguous()
    if q.dtype != torch.int8 or q.shape != (rows, cols) \
            or not q.is_contiguous() or s.numel() != cols:
        raise ValueError(f"{what}: contiguous int8 [{rows}, {cols}] with "
                         f"{cols} scales expected, got {q.dtype} "
                         f"{tuple(q.shape)} and {s.numel()} scales")
    if q.device != dev or s.device != dev:
        raise ValueError(f"{what} and x on different devices")
    return q, s


def _launch(x, nw, wg, wu, wd, eps):
    global launches
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"fused decode MLP kernel takes contiguous bf16 "
                        f"[M, d], got {x.dtype} {tuple(x.shape)}")
    M, d = x.shape
    I = wg["q"].shape[-1]
    if not 1 <= M <= MAX_ROWS or d % 128 or I % 256:
        raise ValueError(f"fused decode MLP kernel needs 1 <= M <= "
                         f"{MAX_ROWS}, d % 128 == 0 and I % 256 == 0: M={M},"
                         f" d={d}, I={I}")
    dev = x.device
    qg, sg = _leaf(wg, d, I, dev, "gate")
    qu, su = _leaf(wu, d, I, dev, "up")
    qd, sd = _leaf(wd, I, d, dev, "down")
    # the norm weight in bf16 as it is (the kernel reads either type)
    nwf = nw.reshape(-1)
    if nwf.dtype != torch.bfloat16:
        nwf = nwf.float()
    nwf = nwf.contiguous()
    if nwf.numel() != d or nwf.device != dev:
        raise ValueError(f"norm weight of {nwf.numel()} on {nwf.device}, "
                         f"expected {d} on {dev}")
    for t in (x, nwf, qg, sg, qu, su, qd, sd):
        if t.data_ptr() % 16:
            raise ValueError("fused decode MLP kernel reads its inputs "
                             "through TMA: 16-byte aligned tensors needed")
    gu_slices, dn_slices = plan(d, I)
    a = torch.empty((M, I), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    lib = _build.load("fused_decode_mlp", _SIG)
    err = lib.fused_decode_mlp_bf16(
        x.data_ptr(), nwf.data_ptr(), qg.data_ptr(), sg.data_ptr(),
        qu.data_ptr(), su.data_ptr(), qd.data_ptr(), sd.data_ptr(),
        a.data_ptr(), out.data_ptr(), M, d, I, eps, gu_slices, dn_slices,
        int(nwf.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_decode_mlp_bf16")
    launches += 1
    return out


def fused_decode_mlp(x, nw, wg, wu, wd, *, eps: float = 1e-5):
    """x [M, d] -> x + SwiGLU-MLP(rms_norm(x)) with int8 weight leaves.
    The CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    _build.refuse_grad("fused decode MLP", x, nw)
    if x.is_cuda:
        return _launch(x, nw, wg, wu, wd, eps)
    if x.device.type != "cpu":
        raise ValueError(f"no fused decode MLP for device {x.device}")
    return fused_decode_mlp_ref(x, nw, wg, wu, wd, eps=eps)
