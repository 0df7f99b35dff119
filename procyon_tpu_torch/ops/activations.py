"""Activations (counterpart of procyon_tpu/ops/activations.py).

gelu_erf_fast is the exact-form GELU 0.5*x*(1+erf(x/sqrt(2))) with erf from
the same odd degree-13 polynomial under tanh as the reference, so both
packages compute one function to f32 rounding.

  * `gelu_erf_ref`: the plain chain, in f32 passes; the CPU's path and
    what the tests hold the kernels to.
  * `gelu_erf_fast(x, bias=None)`: the one wrapper, gelu(x + bias). A CUDA
    tensor goes through `GeluErf` to the hand-written kernels of
    csrc/gelu_erf.cu (bias add and GELU in one pass; under autograd the
    backward kernel, from the saved pre-activation alone): bf16 or f32,
    made contiguous if it is not; another dtype raises TypeError. A CPU
    tensor takes the plain chain. `launches` / `launches_bwd` count the
    kernels' launches.
"""

import ctypes

import torch

from procyon_tpu_torch.ops import _build

_INV_SQRT2 = 0.7071067811865476
_C = (1.1283793939e+00, 1.0276775286e-01, -1.8844757103e-04,
      -6.2315751026e-04, 8.9099016893e-05, -5.9358860429e-06,
      1.5851481176e-07)
_LIM = 4.2

launches = 0
launches_bwd = 0

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIG = {"gelu_erf_fwd": [_P] * 3 + [_LL, _I, _I, _P],
        "gelu_erf_bwd": [_P] * 4 + [_LL, _I, _I, _P]}


def erf_approx(x: torch.Tensor) -> torch.Tensor:
    """erf(x) = tanh(q(x)), q odd degree-13 (max abs error 1.7e-7 in f32)."""
    c0, c1, c2, c3, c4, c5, c6 = _C
    xc = x.clamp(-_LIM, _LIM)
    t = xc * xc
    acc = ((((((c6 * t + c5) * t + c4) * t + c3) * t + c2) * t + c1)
           * t + c0)
    return torch.tanh(xc * acc)


def gelu_erf_ref(x: torch.Tensor) -> torch.Tensor:
    """Exact-form GELU with polynomial erf; computed in f32, returned in the
    input dtype."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + erf_approx(xf * _INV_SQRT2))
    return out.to(x.dtype)


def _launch(name, x, ptrs):
    """gelu_erf_fwd / gelu_erf_bwd on the device pointers `ptrs` (a bias
    of None is a null pointer) over x's rows, on the current stream."""
    lib = _build.load("gelu_erf", _SIG)
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            *(0 if t is None else t.data_ptr() for t in ptrs), x.numel(),
            x.shape[-1], int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)


def _forward(x, bias):
    """gelu(x + bias) by the forward kernel."""
    global launches
    out = torch.empty_like(x)
    if x.numel():
        _launch("gelu_erf_fwd", x, (x, bias, out))
        launches += 1
    return out


def _backward(g, x, bias):
    """g * gelu'(x + bias) by the backward kernel."""
    global launches_bwd
    g = g.contiguous()
    dx = torch.empty_like(x)
    if x.numel():
        _launch("gelu_erf_bwd", x, (g, x, bias, dx))
        launches_bwd += 1
    return dx


class GeluErf(torch.autograd.Function):
    """gelu(x + bias) on the card, x contiguous of bf16 or f32 and bias [F]
    of x's dtype or None. Saves x and bias only; the backward recomputes
    the pre-activation. The bias's gradient, the sum of dx over rows, is
    taken only when asked for."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return _forward(x, bias)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx = _backward(g, x, bias)
        db = None
        if bias is not None and ctx.needs_input_grad[1]:
            db = dx.reshape(-1, dx.shape[-1]).sum(0)
        return (dx if ctx.needs_input_grad[0] else None), db


def gelu_erf_fast(x: torch.Tensor, bias=None) -> torch.Tensor:
    """gelu(x + bias), in the dtype `x + bias` has. A bias of another dtype,
    shape or device than x's last dim is added first, as torch adds it."""
    if bias is not None and (bias.dtype != x.dtype
                             or bias.shape != x.shape[-1:]
                             or bias.device != x.device):
        x, bias = x + bias, None
    if not x.is_cuda:
        return gelu_erf_ref(x if bias is None else x + bias)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gelu_erf_fast on the card takes bf16 or f32, not "
                        f"{x.dtype}")
    return GeluErf.apply(x.contiguous(),
                         None if bias is None else bias.contiguous())
