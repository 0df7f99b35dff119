"""The int8 MLP kernels' shape rule and the plain version's stages.

  * `fused_mlp.kernel_shape`: which rows, widths and requantization groups
    the CUDA kernels of each form take (read from shapes alone, so it is
    tested here), with the block tile of each group;
  * the plain version in the kernels' stages, `ln_quant_rows_ref`, then
    `gelu_codes_ref` (the up kernel: hidden codes and their scales), then
    `mlp_down_ref` (the down kernel), against procyon_tpu's Pallas
    `fused_ln_mlp_int8` / `fused_mlp_int8_prequant` in interpret mode under
    jax.jit, in f32 on the same numpy inputs. The stages' codes against the
    reference's (the body of _kernel / _kernel_pq in jnp): at most 1e-3
    differ, each by one step (a GELU value on a rounding tie, f32 epilogues
    rounding differently in XLA and ATen), the scales within 1e-6 where no
    code of the group moved. The down stage on the reference's own codes
    against the Pallas output: within 1e-5 (f32 sums of the same terms).
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
from torch_cpu_common import one_torch_thread  # noqa: F401

CODE_FLIPS = 1e-3
SG_RTOL = 1e-6
DOWN_ATOL = 1e-5


@pytest.mark.parametrize("kind,M,d,H,want", [
    ("one_pass", 32768, 1280, 5120, (512, 2)),   # ESM2-650M
    ("one_pass", 32768, 2560, 10240, (512, 2)),  # ESM2-3B
    ("one_pass", 512, 320, 1024, (512, 2)),      # ESM2-8M's width
    ("one_pass", 512, 128, 512, (256, 2)),
    ("one_pass", 1, 64, 1536, (256, 2)),         # one row, the least d
    ("one_pass", 40, 1280, 5120, (512, 2)),      # rows beyond a tile
    ("two_pass", 32768, 2560, 10240, (256, 2)),  # ESM2-3B
    ("two_pass", 512, 320, 1280, (128, 2)),      # ESM2-8M
    ("two_pass", 512, 128, 768, (128, 2)),
    ("two_pass", 256, 512, 1920, (128, 1)),
])
def test_kernel_shape_takes(kind, M, d, H, want):
    assert tfm.kernel_shape(kind, M, d, H) == want
    G = want[0]
    rows, cols = tfm.UP_TILES[G]
    assert cols == G and rows * cols == 128 * min(G, 256)


@pytest.mark.parametrize("kind,M,d,H", [
    ("one_pass", 512, 96, 1024),     # d not a multiple of 64
    ("one_pass", 512, 6208, 4096),   # d past the row pass's registers
    ("one_pass", 0, 128, 1024),      # no rows
    ("one_pass", 512, 320, 1280),    # ESM2-8M's H: a group of 128
    ("one_pass", 512, 128, 384),     # a group of 384
    ("two_pass", 512, 96, 1024),     # d not a multiple of 64
    ("two_pass", 512, 128, 192),     # block_n 64: no group
])
def test_kernel_shape_refuses(kind, M, d, H):
    with pytest.raises(ValueError):
        tfm.kernel_shape(kind, M, d, H)


def _inputs(rng, M, d, H):
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


def _reference_codes(args, G):
    """The reference kernel body's hidden codes and scales, in jnp."""
    x, lnw, lnb, w1, s1, b1 = (jnp.asarray(a) for a in args[:6])
    xq, sx = jfm.ln_quant_rows(x, lnw, lnb)
    acc = jnp.dot(xq.astype(jnp.int32), w1.astype(jnp.int32))
    h1 = acc.astype(jnp.float32) * (sx * s1) + b1
    g = 0.5 * h1 * (1.0 + jnp.tanh(0.851 * h1))
    M, H = g.shape
    g = g.reshape(M, H // G, G)
    sg = jnp.maximum(jnp.abs(g).max(-1, keepdims=True), 1e-8) \
        * (1.0 / 127.0)
    gq = jnp.clip(jnp.round(g / sg), -127, 127).astype(jnp.int8)
    return np.array(gq.reshape(M, H)), np.array(sg[..., 0])


@pytest.mark.parametrize("kind,H", [("one_pass", 1024), ("one_pass", 512),
                                    ("two_pass", 1024), ("two_pass", 768)])
@pytest.mark.parametrize("add_residual", [False, True])
def test_stages_compose_to_the_pallas_kernels(kind, H, add_residual):
    rng = np.random.default_rng(H + 2 * add_residual + (kind == "two_pass"))
    M, d = 128, H // 4
    args = _inputs(rng, M, d, H)
    G, per_step = tfm.kernel_shape(kind, M, d, H)
    jfn = jfm.fused_ln_mlp_int8 if kind == "one_pass" \
        else jfm.fused_mlp_int8_prequant
    want = np.asarray(jax.jit(functools.partial(
        jfn, add_residual=add_residual, interpret=True))(
            *(jnp.asarray(a) for a in args)))
    t = [torch.from_numpy(a) for a in args]

    # the stages, on the port's own row codes
    xq, sx = tfm.ln_quant_rows_ref(*t[:3])
    gq, sg = tfm.gelu_codes_ref(xq, sx, *t[3:6], G)
    assert gq.dtype == torch.int8 and sg.shape == (M, H // G)
    gq_j, sg_j = _reference_codes(args, G)
    flips = gq.numpy() != gq_j
    assert flips.mean() <= CODE_FLIPS, flips.mean()
    assert np.abs(gq.numpy().astype(np.int32) - gq_j).max() <= 1
    steady = ~flips.reshape(M, H // G, G).any(-1)
    np.testing.assert_allclose(sg.numpy()[steady], sg_j[steady],
                               rtol=SG_RTOL, atol=0)

    # composed, they are the plain version
    down = tfm.mlp_down_ref(gq, sg, *t[6:9], G, per_step)
    plain = (tfm.fused_ln_mlp_int8_ref if kind == "one_pass"
             else tfm.fused_mlp_int8_prequant_ref)(
        *t, add_residual=add_residual)
    composed = down + t[0] if add_residual else down
    assert torch.equal(composed, plain)

    # the down stage on the reference's codes is the reference's output
    down_j = tfm.mlp_down_ref(torch.from_numpy(gq_j), torch.from_numpy(sg_j),
                              *t[6:9], G, per_step)
    if add_residual:
        down_j = down_j + t[0]
    np.testing.assert_allclose(down_j.numpy(), want, atol=DOWN_ATOL, rtol=0)


def test_serving_layout_keeps_mlp_weights_k_major():
    """The ESM2 serving layout (fuse_qkv_params) keeps each int8 MLP weight
    [in, out] as a view of [out, in] storage, so the kernels' k-major copy
    (bridge.int8_k_major) of a layer's slice copies nothing; the codes are
    the quantized ones."""
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.models import esm2
    cfg = esm2.tiny_config(dim=128, n_heads=2)
    params = esm2.quantize_params(esm2.init_params(0, cfg, device="cpu"),
                                  cfg)
    fused = esm2.fuse_qkv_params(params)
    for name in ("w1", "w2"):
        q = fused["layers"]["mlp"][name]["q"]
        assert torch.equal(q, params["layers"]["mlp"][name]["q"])
        assert q.transpose(-1, -2).is_contiguous()
        layer = q[1]
        kmajor = bridge.int8_k_major(layer)
        assert kmajor.data_ptr() == layer.data_ptr()
        assert torch.equal(kmajor, layer.t())
