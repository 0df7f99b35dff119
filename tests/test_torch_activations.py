"""ops/activations on the CPU: the analytic derivative that the backward
kernel of csrc/gelu_erf.cu computes, written here in torch (`grad_ref`),
against autograd of the plain chain (f64 and f32, across zero and the
clamp's edges at 4.2 * sqrt 2); the bias form against the plain
`gelu_erf_fast(x + b)`; the CPU dispatch on the plain chain for every
dtype and layout, launching nothing, and equal to the JAX package's
gelu_erf_fast; its gradients (the bias's only when asked for) and under a
non-reentrant checkpoint. GeluErf, the kernels' autograd Function, runs on
the card only (tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from procyon_tpu.ops import activations as jact
from procyon_tpu_torch.ops import activations as act

EDGE = 4.2 * 2 ** 0.5


def grad_ref(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """g * d gelu / dx, computed in f32 (f64 stays f64), returned in x's
    dtype: 0.5 (1 + E) + 0.5 x (1 - E^2) (p(t) + 2 t p'(t)) / sqrt 2 with
    E = tanh(xc p(t)), t = xc^2, xc = clamp(x / sqrt 2, -4.2, 4.2); the
    second term is zero where the clamp is active (at the bounds themselves
    torch's clamp passes the gradient). The backward kernel's function."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    u = xf * act._INV_SQRT2
    xc = u.clamp(-act._LIM, act._LIM)
    t = xc * xc
    p = torch.zeros_like(t)
    dp = torch.zeros_like(t)
    for k in range(len(act._C) - 1, -1, -1):
        p = p * t + act._C[k]
        if k:
            dp = dp * t + k * act._C[k]
    e = torch.tanh(xc * p)
    inside = (u >= -act._LIM) & (u <= act._LIM)
    d = 0.5 * (1.0 + e) + torch.where(
        inside, 0.5 * xf * (1.0 - e * e) * (p + 2.0 * t * dp) * act._INV_SQRT2,
        0.0)
    return (g.to(xf.dtype) * d).to(x.dtype)


def _points(dtype):
    """A sweep over [-8, 8], zero, and both clamp edges with points just
    inside and outside them."""
    near = torch.tensor([0.0, -0.0, EDGE, -EDGE], dtype=torch.float64)
    eps = torch.tensor([1e-6, 1e-4, 1e-2], dtype=torch.float64)
    x = torch.cat([torch.linspace(-8.0, 8.0, 4001, dtype=torch.float64), near,
                   EDGE + eps, EDGE - eps, -EDGE + eps, -EDGE - eps])
    return x.to(dtype)


def test_derivative_matches_autograd_in_f64():
    """In f64 the chain's autograd and the analytic derivative agree to
    rounding: the same function, differentiated two ways."""
    x = _points(torch.float64).requires_grad_(True)
    g = torch.linspace(-2.0, 3.0, x.numel(), dtype=torch.float64)
    y = 0.5 * x * (1.0 + act.erf_approx(x * act._INV_SQRT2))
    (want,) = torch.autograd.grad(y, x, g)
    got = grad_ref(g, x.detach())
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-13)


def test_derivative_matches_autograd_of_the_f32_chain():
    """In f32 against autograd of gelu_erf_fast itself: within f32 rounding
    of the terms (the derivative's own zero near x = -0.75 is a difference
    of two terms of about 0.5, hence the absolute part)."""
    x = _points(torch.float32).requires_grad_(True)
    g = torch.linspace(-2.0, 3.0, x.numel())
    (want,) = torch.autograd.grad(act.gelu_erf_fast(x), x, g)
    got = grad_ref(g, x.detach())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=4e-6, atol=1e-6)


def test_clamp_edges_pass_only_the_outer_term():
    """Past the clamp the derivative is 0.5 (1 + E(+-4.2)) alone, the same
    wherever x lies out there: the polynomial's term is cut."""
    x = torch.tensor([EDGE + 0.5, 20.0, -EDGE - 0.5, -20.0],
                     dtype=torch.float64)
    d = grad_ref(torch.ones_like(x), x)
    lim = torch.tensor([4.2, -4.2], dtype=torch.float64)
    outer = 0.5 * (1.0 + act.erf_approx(lim))
    assert torch.equal(d, outer.repeat_interleave(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", ["same", torch.float32, None])
def test_bias_form_equals_the_plain_sum(dtype, bias_dtype):
    """gelu_erf_fast(x, b) is gelu_erf_fast(x + b) bit for bit, in the
    dtype torch's sum has (an f32 bias on bf16 rows gives f32)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(3 * rng.standard_normal((6, 5, 40))).to(dtype)
    b = None if bias_dtype is None else torch.from_numpy(
        rng.standard_normal(40)).to(dtype if bias_dtype == "same"
                                    else bias_dtype)
    want = act.gelu_erf_fast(x if b is None else x + b)
    got = act.gelu_erf_fast(x, b)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["f32", "f16", "strided"])
def test_cpu_dispatch_stays_on_the_plain_chain(layout):
    """On the CPU the wrapper runs the plain chain (the same bits) for every
    dtype and layout, launches no kernel and builds nothing; in f32 it
    matches the JAX package's GELU."""
    from procyon_tpu_torch.ops import _build
    rng = np.random.default_rng(9)
    x = (3 * rng.standard_normal((16, 96))).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    if layout == "f16":
        xt, bt = xt.half(), bt.half()
    elif layout == "strided":
        xt, bt = xt.t().contiguous().t(), bt
        assert not xt.is_contiguous()
    before = (act.launches, act.launches_bwd)
    xg = xt.clone().requires_grad_(True) if layout == "f32" else xt
    out = act.gelu_erf_fast(xg, bt)
    if layout == "f32":
        out.sum().backward()
    assert (act.launches, act.launches_bwd) == before
    assert "gelu_erf" not in _build._libs
    assert torch.equal(out.detach(), act.gelu_erf_ref(xt + bt))
    if layout == "f32":
        np.testing.assert_allclose(
            out.detach().numpy(),
            np.asarray(jact.gelu_erf_fast(jnp.asarray(x) + jnp.asarray(b))),
            atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bias_grad", [True, False])
def test_cpu_gradients_match_the_analytic_derivative(bias_grad):
    """gelu_erf_fast(x, b) on the CPU: the input's gradient is the analytic
    derivative's at x + b, the bias's the rows' sum of it, and None where
    the bias asks for none."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(3 * rng.standard_normal((7, 4, 33))).float()
    b = torch.from_numpy(rng.standard_normal(33)).float()
    g = torch.from_numpy(rng.standard_normal((7, 4, 33))).float()
    xa, ba = x.clone().requires_grad_(True), b.clone().requires_grad_(
        bias_grad)
    out = act.gelu_erf_fast(xa, ba)
    assert torch.equal(out.detach(), act.gelu_erf_ref(x + b))
    out.backward(g)
    want = grad_ref(g, x + b)
    torch.testing.assert_close(xa.grad, want, rtol=4e-6, atol=1e-6)
    if bias_grad:
        torch.testing.assert_close(ba.grad, want.sum((0, 1)), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert ba.grad is None


def test_cpu_path_under_a_nonreentrant_checkpoint():
    """Recomputed under torch.utils.checkpoint (use_reentrant=False, as
    ESM2's remat runs a layer), the bias form gives the gradients it gives
    without it, bit for bit."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((9, 24))).float()
    w = torch.from_numpy(rng.standard_normal((24, 40)) / 5).float()
    b = torch.from_numpy(rng.standard_normal(40)).float()

    def layer(inp):
        return act.gelu_erf_fast(inp @ w, b)

    grads = []
    for remat in (False, True):
        xi = x.clone().requires_grad_(True)
        y = torch.utils.checkpoint.checkpoint(
            layer, xi, use_reentrant=False) if remat else layer(xi)
        (y * y).sum().backward()
        grads.append(xi.grad)
    assert torch.equal(grads[0], grads[1])
