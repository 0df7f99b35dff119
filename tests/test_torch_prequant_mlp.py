"""procyon_tpu_torch's two-pass int8 MLP against procyon_tpu's Pallas
kernels in interpret mode under jax.jit, in f32 (and one case in bf16) on
the same numpy inputs:

  * `ln_quant_rows` (the plain version of the LN + row quantization
    kernel) against `ln_quant_rows_pallas`: the int8 codes equal except at
    rounding ties (the f32 statistics are summed in another order), at
    most 1e-3 of them and each by one step; the scales within 1e-6
    relative of the reference's lane-broadcast [M, 128] column 0;
  * `fused_mlp_int8_prequant` (the plain version of the row pass + the
    MLP kernel) against the reference's `fused_mlp_int8_prequant`, at H
    1024 (G 256 where the one-pass form takes 512) and H 768 (G 128, two
    groups a step, where the one-pass form takes 384), with and without
    the residual: at most 1e-3 of the hidden codes differ, each by one
    step; each output row within 1e-5 plus one quantization step of the
    second product per flipped code of that row, as in
    test_torch_fused_mlp.py;
  * the residual added after the output cast, in bf16 (the reference's
    order, one rounding more than the one-pass form's).

Also: the group rule, the wrappers on the CPU (no launch), other devices
refused, and the port's probe script on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import fused_mlp as jfm
from procyon_tpu.ops import quant as jquant
from procyon_tpu_torch.ops import fused_mlp as tfm
from procyon_tpu_torch.scripts import probe_fused_mlp_blocks as tprobe
from torch_cpu_common import one_torch_thread  # noqa: F401

CODE_FLIPS = 1e-3
SX_RTOL = 1e-6


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


def _code_flips(got, want):
    flips = got != want
    assert flips.mean() <= CODE_FLIPS, flips.mean()
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    return flips


def test_ln_quant_rows_matches_pallas():
    rng = np.random.default_rng(11)
    M, d = 256, 256
    x = (2.0 * rng.standard_normal((M, d))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    xq_j, sx_j = jax.jit(functools.partial(
        jfm.ln_quant_rows_pallas, interpret=True))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xq_j, sx_j = np.asarray(xq_j), np.asarray(sx_j)
    assert sx_j.shape == (M, 128)
    for fn in (tfm.ln_quant_rows_ref, tfm.ln_quant_rows):
        before = tfm.launches_ln_quant
        xq, sx = fn(*(torch.from_numpy(a) for a in (x, w, b)))
        assert tfm.launches_ln_quant == before
        assert xq.dtype == torch.int8 and sx.shape == (M, 1)
        _code_flips(xq.numpy(), xq_j)
        np.testing.assert_allclose(sx.numpy(), sx_j[:, :1], rtol=SX_RTOL,
                                   atol=0)


def _hidden_codes(args, G):
    """The reference's int8 GELU codes [M, H] and the port's scales
    [M, H/G] for a group G, from the reference's row pass (the body of
    _kernel_pq, fused_mlp.py:129-151) and from the port's."""
    x, lnw, lnb, w1, s1, b1 = args[:6]
    M, H = len(x), w1.shape[1]
    out = []
    for lib in ("jax", "torch"):
        if lib == "jax":
            xq, sx = jfm.ln_quant_rows(*(jnp.asarray(a) for a in (x, lnw,
                                                                  lnb)))
            acc = jnp.dot(xq.astype(jnp.int32),
                          jnp.asarray(w1).astype(jnp.int32))
            h1 = acc.astype(jnp.float32) * (sx * jnp.asarray(s1)) \
                + jnp.asarray(b1)
            g = np.asarray(0.5 * h1 * (1.0 + jnp.tanh(0.851 * h1)))
        else:
            xq, sx = tfm.ln_quant_rows_ref(*(torch.from_numpy(a)
                                             for a in (x, lnw, lnb)))
            h1 = torch._int_mm(xq, torch.from_numpy(w1)).float() \
                * (sx * torch.from_numpy(s1)) + torch.from_numpy(b1)
            g = (0.5 * h1 * (1.0 + torch.tanh(0.851 * h1))).numpy()
        g = g.reshape(M, H // G, G)
        sg = np.maximum(np.abs(g).max(-1, keepdims=True), 1e-8) \
            * np.float32(1.0 / 127.0)
        out.append((np.clip(np.round(g / sg), -127, 127).reshape(M, H),
                    sg[..., 0]))
    return out


@pytest.mark.parametrize("H", [1024, 768])
@pytest.mark.parametrize("add_residual", [False, True])
def test_prequant_mlp_matches_pallas(H, add_residual):
    rng = np.random.default_rng(H + add_residual)
    M, d = 256, H // 4
    G = tfm.prequant_group(H)
    assert G != tfm.requant_group(H)
    args = _mlp_inputs(rng, M, d, H)
    want = np.asarray(jax.jit(functools.partial(
        jfm.fused_mlp_int8_prequant, add_residual=add_residual,
        interpret=True))(*(jnp.asarray(a) for a in args)))
    before = tfm.launches_prequant
    got = tfm.fused_mlp_int8_prequant(
        *(torch.from_numpy(a) for a in args),
        add_residual=add_residual).numpy()
    assert tfm.launches_prequant == before
    assert np.abs(want).max() > 0.1

    (gq_j, _), (gq_t, sg_t) = _hidden_codes(args, G)
    flips = _code_flips(gq_t, gq_j)
    w2_step = np.abs(args[6] * args[7]).max()
    bound = 1e-5 + flips.sum(1) * sg_t.max(1) * w2_step
    assert (np.abs(got - want).max(1) <= bound).all()


def test_prequant_residual_is_added_after_the_cast():
    """In bf16 the two-pass form rounds the MLP's output to bf16 and then
    adds x in bf16 (fused_mlp.py:276-279). Against the reference in bf16:
    each output within one bf16 ulp (2^-7 relative) of its row's largest
    MLP value (the first rounding) and of itself (the second), plus the
    code flips' share as above."""
    rng = np.random.default_rng(5)
    M, d, H = 64, 256, 1024
    args = list(_mlp_inputs(rng, M, d, H))
    args[0] = np.asarray(jnp.asarray(args[0], jnp.bfloat16), np.float32)
    tx = torch.from_numpy(args[0]).to(torch.bfloat16)
    targs = (tx, *(torch.from_numpy(a) for a in args[1:]))
    with_res = tfm.fused_mlp_int8_prequant_ref(*targs, add_residual=True)
    without = tfm.fused_mlp_int8_prequant_ref(*targs, add_residual=False)
    assert without.dtype == torch.bfloat16
    assert torch.equal(with_res, without + tx)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jnp.asarray(args[0], jnp.bfloat16)
    want = np.asarray(jax.jit(functools.partial(
        jfm.fused_mlp_int8_prequant, add_residual=True,
        interpret=True))(*jargs), np.float32)
    got = with_res.float().numpy()
    (gq_j, _), (gq_t, sg_t) = _hidden_codes(args, tfm.prequant_group(H))
    flips = _code_flips(gq_t, gq_j)
    w2_step = np.abs(args[6] * args[7]).max()
    mlp_row = np.abs(without.float().numpy()).max(1, keepdims=True)
    bound = 2.0 ** -7 * (np.abs(want) + mlp_row) \
        + (flips.sum(1) * sg_t.max(1) * w2_step)[:, None]
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("H,G", [(1024, 256), (10240, 256), (5120, 256),
                                 (768, 128), (1920, 128), (2560, 256)])
def test_prequant_group_rule(H, G):
    assert tfm.prequant_group(H) == G


def test_wrappers_refuse_other_devices():
    x = torch.empty((512, 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        tfm.ln_quant_rows(x, x[0], x[0])
    with pytest.raises(ValueError, match="device"):
        tfm.fused_mlp_int8_prequant(x, *([x] * 8))


def test_port_probe_runs_both_forms_on_the_cpu(capsys):
    res = tprobe.main(["--device", "cpu", "--dim", "128", "--ffn", "1024",
                       "--rows", "64"])
    assert res["finite"] and res["groups"] == {"one_pass": 512,
                                               "two_pass": 256}
    assert res["one_pass_tops"] is None and res["two_pass_weight_gb"] is None
    assert "not measured" in capsys.readouterr().out
