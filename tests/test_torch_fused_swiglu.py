"""procyon_tpu_torch's RMSNorm + W8A8 SwiGLU MLP (kernel row 7, the plain
version through the wrapper on CPU tensors) against procyon_tpu's
fused_rms_swiglu_int8 in interpret mode under jax.jit, in f32 on the same
numpy inputs and the same int8 leaves (procyon_tpu.ops.quant.quantize):

  * at the reference test's shape (M 256, d 256, H 512, block_m 128,
    block_n 256: G 128), at d 128 / H 384 (sub_tiles falls to 1: G 384)
    and with M 200, not a multiple of the reference's block_m (its wrapper
    halves block_m to 8): every output row within 1e-5 of the reference
    plus 2 hidden-code steps of that row (step = the row's largest group
    scale times the largest |down weight|), and at most 2% of the rows
    beyond the 1e-5: the SiLU * u codes can take the neighbouring value
    where a product lies on a rounding tie (the row statistics are summed
    in another order);
  * no worse than the port's W8A8 route (llama._mlp in "w8a8") against the
    exact f32 MLP on dequantized weights, the bound of
    tests/test_quant_kernels.py::TestFusedRmsSwiglu;
  * the group rule at the path's shapes and the reference test's;
  * the same bits for contiguous [in, out] weights and for [in, out]
    views of [out, in] storage (what the CUDA kernels read without a
    copy);
  * the wrapper on other devices and on inputs that require grad.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import fused_mlp as jfm
from procyon_tpu.ops import quant as jquant
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.ops import fused_mlp as tfm
from procyon_tpu_torch.ops import quant as tquant
from torch_cpu_common import one_torch_thread  # noqa: F401

ROW_ATOL = 1e-5
ROW_STEPS = 2.0
ROWS_OFF = 0.02


def _inputs(M, d, H, seed):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((M, d))).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    out = [x, nw]
    for shape in ((d, H), (d, H), (H, d)):
        w = jquant.quantize(jnp.asarray(
            rng.standard_normal(shape).astype(np.float32)
            / np.sqrt(shape[0])))
        out += [np.array(w["q"]), np.array(w["s"])]
    return out


def _steps(args, G):
    """The largest move one SiLU * u code flip gives each output row."""
    t = [torch.from_numpy(a) for a in args]
    xq, sx = tfm.rms_quant_rows_ref(t[0], t[1])
    _, sa = tfm.swiglu_codes_ref(xq, sx, *t[2:6], G)
    return sa.numpy().max(1) * np.abs(args[6] * args[7]).max()


@pytest.mark.parametrize("M,d,H,block_n,G", [
    (256, 256, 512, 256, 128),    # tests/test_quant_kernels.py's shape
    (128, 128, 384, 512, 384),    # sub_tiles falls to 1
    (200, 256, 512, 256, 128),    # M not a multiple of block_m
])
def test_matches_pallas_interpret(M, d, H, block_n, G):
    assert tfm.swiglu_group(d, H, block_n) == G
    args = _inputs(M, d, H, M + d + H)
    want = np.asarray(jax.jit(functools.partial(
        jfm.fused_rms_swiglu_int8, block_m=128, block_n=block_n,
        interpret=True))(*(jnp.asarray(a) for a in args)))
    before = tfm.launches_swiglu
    got = tfm.fused_rms_swiglu_int8(*(torch.from_numpy(a) for a in args),
                                    block_n=block_n).numpy()
    assert tfm.launches_swiglu == before
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want - args[0]).max() > 0.5     # the MLP moves x
    err = np.abs(got - want).max(1)
    assert (err <= ROW_ATOL + ROW_STEPS * _steps(args, G)).all()
    assert (err > ROW_ATOL).mean() <= ROWS_OFF


def test_no_worse_than_the_w8a8_route():
    """Against the exact MLP in f32 on the dequantized weights: the port's
    kernel function within 1.25x (+1e-4) of the port's W8A8 route's error,
    and within 8e-2 of the route (abs and rel): they differ by the SiLU * u
    requantization grid (per 128 columns against per row)."""
    M, d, H = 256, 256, 512
    t = [torch.from_numpy(a) for a in _inputs(M, d, H, 0)]
    x, nw = t[:2]
    leaves = [{"q": t[i], "s": t[i + 1]} for i in (2, 4, 6)]
    lp = {"mlp_norm": nw, "mlp": dict(zip(("w_gate", "w_up", "w_down"),
                                          leaves))}
    cfg = tllama.tiny_config(dim=d, intermediate=H)
    route = tllama._mlp(x, lp, cfg, "w8a8")
    h = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * nw
    wg, wu, wd = (tquant.dequantize(w, torch.float32) for w in leaves)
    exact = x + (torch.nn.functional.silu(h @ wg) * (h @ wu)) @ wd
    got = tfm.fused_rms_swiglu_int8(*t, block_n=256)
    np.testing.assert_allclose(got.numpy(), route.numpy(), atol=8e-2,
                               rtol=8e-2)
    err_kernel = float((got - exact).norm() / exact.norm())
    err_route = float((route - exact).norm() / exact.norm())
    assert err_kernel <= err_route * 1.25 + 1e-4, (err_kernel, err_route)


@pytest.mark.parametrize("d,H,block_n,G", [
    (4096, 11008, 512, 128),      # the Bind prefill
    (4096, 14336, 512, 128),      # Llama-3-8B
    (2560, 10240, 512, 256),
    (128, 384, 512, 384),
    (256, 512, 256, 128),
])
def test_group_rule(d, H, block_n, G):
    assert tfm.swiglu_group(d, H, block_n) == G


@pytest.mark.parametrize("M,d,H,block_n", [(64, 256, 512, 256),
                                             (40, 128, 384, 512)])
def test_weight_layouts_give_the_same_bits(M, d, H, block_n):
    """The [in, out] weights as contiguous tensors and as views of
    [out, in] storage (the layout the CUDA kernels read without a copy,
    SWIGLU_WEIGHT_LAYOUT): the same bits through the wrapper."""
    args = [torch.from_numpy(a) for a in _inputs(M, d, H, 7)]
    views = [t.t().contiguous().t() if t.dtype == torch.int8 else t
             for t in args]
    assert tfm.SWIGLU_WEIGHT_LAYOUT == "out_in"
    assert not views[2].is_contiguous() and views[2].t().is_contiguous()
    assert torch.equal(views[2], args[2])
    want = tfm.fused_rms_swiglu_int8(*args, block_n=block_n)
    got = tfm.fused_rms_swiglu_int8(*views, block_n=block_n)
    assert torch.equal(got, want)


def test_wrapper_refuses_other_devices_and_grad():
    x = torch.empty((64, 128), device="meta")
    w = torch.empty((128, 128), dtype=torch.int8, device="meta")
    s = torch.empty((1, 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        tfm.fused_rms_swiglu_int8(x, x[0], w, s, w, s, w, s)
    with pytest.raises(RuntimeError, match="grad"):
        tfm.fused_rms_swiglu_int8(x.requires_grad_(), x[0], w, s, w, s, w, s)
