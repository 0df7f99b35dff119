"""procyon_tpu_torch fused LayerNorm + int8 MLP (the plain version of the
CUDA kernel) against procyon_tpu's Pallas `fused_ln_mlp_int8` in interpret
mode on the CPU, in f32 on the same numpy inputs, plus the ops it is built
from (quantization, W8A8 matmul, LayerNorm, GELU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import activations as jact
from procyon_tpu.ops import fused_mlp as jfm
from procyon_tpu.ops import norms as jnorms
from procyon_tpu.ops import quant as jquant
from procyon_tpu_torch.ops import activations as tact
from procyon_tpu_torch.ops import fused_mlp as tfm
from procyon_tpu_torch.ops import norms as tnorms
from procyon_tpu_torch.ops import quant as tquant
# one torch thread: with several, how an elementwise pass is split over
# threads varies from run to run beside JAX's thread pools, and a split
# that moves a vector loop's scalar tail moves tanh by an ulp, enough to
# flip a code on a rounding tie between the plain version and the
# hidden-code check below
from torch_cpu_common import one_torch_thread  # noqa: F401


def _mlp_inputs(rng, M, d, H):
    x = rng.standard_normal((M, d)).astype(np.float32)
    lnw = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(d)).astype(np.float32)
    q1 = jquant.quantize(jnp.asarray(
        rng.standard_normal((d, H)).astype(np.float32) / np.sqrt(d)))
    q2 = jquant.quantize(jnp.asarray(
        rng.standard_normal((H, d)).astype(np.float32) / np.sqrt(H)))
    b1 = (0.1 * rng.standard_normal(H)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return (x, lnw, lnb, np.array(q1["q"]), np.array(q1["s"]), b1,
            np.array(q2["q"]), np.array(q2["s"]), b2)


def _hidden_codes(args, *, lib):
    """The int8 GELU codes [M, H] and their scales [M, H/G] as the kernels
    compute them, in `lib`'s own ops: jnp for the reference (the body of
    fused_mlp._kernel, fused_mlp.py:42-86), torch for the port."""
    x, lnw, lnb, w1, s1, b1 = args[:6]
    H = w1.shape[1]
    G = tfm.requant_group(H)
    if lib == "jax":
        xq, sx = jfm.ln_quant_rows(*(jnp.asarray(a) for a in (x, lnw, lnb)))
        acc = np.asarray(jnp.dot(xq.astype(jnp.int32),
                                 jnp.asarray(w1).astype(jnp.int32)))
        h1 = jnp.asarray(acc, jnp.float32) * (sx * jnp.asarray(s1)) \
            + jnp.asarray(b1)
        g = 0.5 * h1 * (1.0 + jnp.tanh(0.851 * h1))
    else:
        h = tnorms.layer_norm(*(torch.from_numpy(a) for a in (x, lnw, lnb)))
        xq, sx = tquant.quantize_rows(h)
        acc = torch._int_mm(xq, torch.from_numpy(w1))
        h1 = acc.float() * (sx * torch.from_numpy(s1)) + torch.from_numpy(b1)
        g = 0.5 * h1 * (1.0 + torch.tanh(0.851 * h1))
    g = np.asarray(g).reshape(len(x), H // G, G)
    sg = np.maximum(np.abs(g).max(-1, keepdims=True), 1e-8) * np.float32(
        1.0 / 127.0)
    gq = np.clip(np.round(g / sg), -127, 127).reshape(len(x), H)
    return gq, sg[..., 0]


@pytest.mark.parametrize("H", [512, 1024])
@pytest.mark.parametrize("add_residual", [False, True])
def test_fused_mlp_matches_pallas(H, add_residual):
    """The int32 products are exact, but the f32 epilogue (tanh, the sums)
    rounds differently in XLA and ATen, so a GELU value on an int8 rounding
    tie can take the neighbouring code. Held to: at most 0.1% of the
    hidden codes differ, each by one step; each output row is within 1e-5
    plus one quantization step (sg * max|W2 dequantized|) per flipped code
    of that row. G is 256 at H=512 and 512 at H=1024, as the reference
    derives it."""
    rng = np.random.default_rng(H + add_residual)
    M, d = 256, H // 4
    args = _mlp_inputs(rng, M, d, H)
    want = np.asarray(jfm.fused_ln_mlp_int8(
        *(jnp.asarray(a) for a in args), add_residual=add_residual,
        interpret=True))
    got = tfm.fused_ln_mlp_int8(*(torch.from_numpy(a) for a in args),
                                add_residual=add_residual).numpy()
    assert np.abs(want).max() > 0.1

    gq_j, _ = _hidden_codes(args, lib="jax")
    gq_t, sg_t = _hidden_codes(args, lib="torch")
    flips = gq_j != gq_t
    assert flips.mean() <= 1e-3, flips.mean()
    assert np.abs(gq_j - gq_t).max() <= 1
    w2_step = np.abs(args[6] * args[7]).max()
    bound = 1e-5 + flips.sum(1) * sg_t.max(1) * w2_step
    assert (np.abs(got - want).max(1) <= bound).all()


@pytest.mark.parametrize("H,G", [(512, 256), (1024, 512), (5120, 512),
                                 (10240, 512), (1536, 256)])
def test_requant_group_rule(H, G):
    assert tfm.requant_group(H) == G


def test_ln_quant_codes_match():
    """LayerNorm + per-row int8 codes of the plain version equal the
    reference's ln_quant_rows exactly (half-to-even rounding)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = np.ones(256, np.float32)
    b = np.zeros(256, np.float32)
    xq_j, sx_j = jfm.ln_quant_rows(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))
    h = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    xq_t, sx_t = tquant.quantize_rows(h)
    np.testing.assert_allclose(sx_t.numpy(), np.asarray(sx_j), rtol=1e-6)
    assert (xq_t.numpy() != np.asarray(xq_j)).mean() <= 1e-3


def test_quantize_and_w8a8_match():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 64, 96)).astype(np.float32)
    qj = jquant.quantize(jnp.asarray(w))
    qt = tquant.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(qt["q"].numpy(), np.asarray(qj["q"]))
    # 1 ulp: XLA may turn the division by 127 into a multiplication by
    # its reciprocal
    np.testing.assert_allclose(qt["s"].numpy(), np.asarray(qj["s"]),
                               rtol=2.5e-7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    lj = {"q": qj["q"][0], "s": qj["s"][0]}
    lt = {"q": qt["q"][0], "s": qt["s"][0]}
    want = np.asarray(jquant.mm(jnp.asarray(x), lj, "w8a8"))
    got = tquant.mm(torch.from_numpy(x), lt, "w8a8").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tquant.dequantize(lt, torch.float32).numpy(),
        np.asarray(jquant.dequantize(lj, jnp.float32)), rtol=2.5e-7)
    want = np.asarray(jquant.mm(jnp.asarray(x), lj, "dequant"))
    got = tquant.mm(torch.from_numpy(x), lt, "dequant").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layer_norm_and_gelu_match():
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((8, 128))).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.layer_norm(*(torch.from_numpy(a) for a in (x, w, b))).numpy(),
        np.asarray(jnorms.layer_norm(*(jnp.asarray(a) for a in (x, w, b)))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tact.gelu_erf_fast(torch.from_numpy(x)).numpy(),
        np.asarray(jact.gelu_erf_fast(jnp.asarray(x))), atol=1e-6,
        rtol=1e-6)


def test_wrapper_refuses_other_devices():
    x = torch.empty((512, 128), device="meta")
    with pytest.raises(ValueError):
        tfm.fused_ln_mlp_int8(x, *([x] * 8))
