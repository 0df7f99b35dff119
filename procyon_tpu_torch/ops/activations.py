"""Activations (counterpart of procyon_tpu/ops/activations.py).

gelu_erf_fast is the exact-form GELU 0.5*x*(1+erf(x/sqrt(2))) with erf from
the same odd degree-13 polynomial under tanh as the reference, so both
packages compute one function to f32 rounding.
"""

import torch

_INV_SQRT2 = 0.7071067811865476


def erf_approx(x: torch.Tensor) -> torch.Tensor:
    """erf(x) = tanh(q(x)), q odd degree-13 (max abs error 1.7e-7 in f32)."""
    c0, c1, c2 = 1.1283793939e+00, 1.0276775286e-01, -1.8844757103e-04
    c3, c4 = -6.2315751026e-04, 8.9099016893e-05
    c5, c6 = -5.9358860429e-06, 1.5851481176e-07
    xc = x.clamp(-4.2, 4.2)
    t = xc * xc
    acc = ((((((c6 * t + c5) * t + c4) * t + c3) * t + c2) * t + c1)
           * t + c0)
    return torch.tanh(xc * acc)


def gelu_erf_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact-form GELU with polynomial erf; computed in f32, returned in the
    input dtype."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + erf_approx(xf * _INV_SQRT2))
    return out.to(x.dtype)
