"""Fused LayerNorm -> int8 W1 -> GELU -> int8 W2 MLP (counterpart of
procyon_tpu/ops/fused_mlp.py::fused_ln_mlp_int8).

`fused_ln_mlp_int8` is the one wrapper. On a CUDA tensor it launches the
hand-written kernel in csrc/fused_ln_mlp_int8.cu (bf16 activations) or
raises; on a CPU tensor it runs `fused_ln_mlp_int8_ref`, the plain PyTorch
version of the same function. `launches` counts kernel launches.

Numerics (both versions, as the TPU kernel): LayerNorm in f32, per-row int8
quantization of its output, s8 x s8 -> s32 with W1, `h1 = acc*(sx*s1)+b1`,
sigmoid-form GELU `0.5 h1 (1 + tanh(0.851 h1))`, requantization per
(row, G-column group), s8 x s8 -> s32 with W2, `acc2*(sg*s2)` summed in f32,
`+b2`, `+x` when add_residual. G is numerics, not tuning: `requant_group`
derives it from the reference's block_n / sub_tiles rule.
"""

import ctypes

import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.ops import _build

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "fused_ln_mlp_int8_bf16": [_P] * 10 + [_I] * 5
    + [ctypes.c_float, _I, _P],
    "fused_ln_mlp_int8_smem": [_I, _I, _I],
}


def requant_group(H: int) -> int:
    """Width of the hidden tile over which the GELU output shares one int8
    scale: block_n halves from min(1024, H) until it divides H, sub_tiles
    halves from 2 until block_n % (sub_tiles*128) == 0, G = block_n /
    sub_tiles (fused_mlp.py:311-316, 347-348)."""
    block_n = _block_n(H)
    sub_tiles = 2
    while block_n % (sub_tiles * 128):
        sub_tiles //= 2
    return block_n // max(sub_tiles, 1)


def _block_n(H: int) -> int:
    block_n = 1024
    if H % block_n:
        block_n = min(block_n, H)
        while H % block_n:
            block_n //= 2
    return block_n


def fused_ln_mlp_int8_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                          eps: float = 1e-5,
                          add_residual: bool = False) -> torch.Tensor:
    """Plain PyTorch version. x [M, d]; w1q int8 [d, H], s1 f32 [1, H];
    w2q int8 [H, d], s2 f32 [1, d]; b1 [H], b2 [d], ln_w/ln_b [d].
    Sums the per-group partials in the reference's order (the groups of one
    block_n step first, then into the accumulator)."""
    M, d = x.shape
    H = w1q.shape[1]
    G = requant_group(H)
    per_step = _block_n(H) // G
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    cx = xf - mean
    var = (cx * cx).mean(-1, keepdim=True)
    h = cx * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    amax = h.abs().amax(-1, keepdim=True)
    sx = amax.clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.round(h / sx).clamp(-127, 127).to(torch.int8)
    s1 = s1.reshape(1, H).float()
    s2 = s2.reshape(1, d).float()
    b1 = b1.reshape(1, H).float()
    acc = torch.zeros((M, d), dtype=torch.float32, device=x.device)
    total = None
    for j in range(H // G):
        sl = slice(j * G, (j + 1) * G)
        a1 = torch._int_mm(xq, w1q[:, sl].contiguous())
        h1 = a1.float() * (sx * s1[:, sl]) + b1[:, sl]
        g = 0.5 * h1 * (1.0 + torch.tanh(0.851 * h1))
        gmax = g.abs().amax(-1, keepdim=True)
        sg = gmax.clamp_min(1e-8) * (1.0 / 127.0)
        gq = torch.round(g / sg).clamp(-127, 127).to(torch.int8)
        a2 = torch._int_mm(gq, w2q[sl, :].contiguous())
        part = a2.float() * (sg * s2)
        total = part if total is None else total + part
        if (j + 1) % per_step == 0:
            acc = acc + total
            total = None
    out = acc + b2.reshape(1, d).float()
    if add_residual:
        out = out + xf
    return out.to(x.dtype)


def _launch(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps, add_residual):
    global launches
    M, d = x.shape
    H = w1q.shape[1]
    G = requant_group(H)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"fused MLP kernel takes contiguous bf16 x, got "
                        f"{x.dtype} contiguous={x.is_contiguous()}")
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8 \
            or w1q.shape != (d, H) or w2q.shape != (H, d):
        raise ValueError(f"int8 weights [d, H] / [H, d] expected, got "
                         f"{w1q.dtype} {tuple(w1q.shape)} / {w2q.dtype} "
                         f"{tuple(w2q.shape)}")
    if d % 64 or G not in (256, 512) or H % G:
        raise ValueError(f"fused MLP kernel needs d % 64 == 0 and a "
                         f"requantization group of 256 or 512: d={d}, H={H}, "
                         f"G={G}")
    dev = x.device
    vecs = [t.reshape(-1).float().contiguous()
            for t in (ln_w, ln_b, s1, b1, s2, b2)]
    for t, n in zip(vecs, (d, d, H, H, d, d)):
        if t.numel() != n or t.device != dev:
            raise ValueError(f"vector of {t.numel()} on {t.device}, "
                             f"expected {n} on {dev}")
    lnw, lnb, s1f, b1f, s2f, b2f = vecs
    if w1q.device != dev or w2q.device != dev:
        raise ValueError("weights and x on different devices")
    w1t, w2t = bridge.int8_k_major(w1q), bridge.int8_k_major(w2q)
    lib = _build.load("fused_ln_mlp_int8", _SIG)
    bm = next((b for b in (32, 16)
               if M % b == 0 and lib.fused_ln_mlp_int8_smem(b, d, G) > 0),
              None)
    if bm is None:
        raise ValueError(f"no row block fits: M={M}, d={d}, G={G}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_ln_mlp_int8_bf16(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1t.data_ptr(),
        s1f.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), s2f.data_ptr(),
        b2f.data_ptr(), out.data_ptr(), M, d, H, G, bm, eps,
        int(add_residual), stream)
    _build.check(err, "fused_ln_mlp_int8_bf16")
    launches += 1
    return out


def fused_ln_mlp_int8(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                      eps: float = 1e-5,
                      add_residual: bool = False) -> torch.Tensor:
    """x [M, d] -> LN -> int8 GELU MLP -> [M, d] (+ x when add_residual).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return _launch(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps,
                       add_residual)
    if x.device.type != "cpu":
        raise ValueError(f"no fused MLP for device {x.device}")
    return fused_ln_mlp_int8_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2,
                                 eps=eps, add_residual=add_residual)
