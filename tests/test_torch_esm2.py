"""procyon_tpu_torch ESM2 against procyon_tpu's ESM2 on the CPU in f32, with
the reference's parameters carried across through the bridge, and against
the frozen HF golden logits.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.esm2 as jesm
from procyon_tpu.models import checkpoint_io
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import esm2 as tesm

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "esm2_tiny.npz")


def _port_cfg(jcfg, **kw):
    """The port's config with the reference config's fields."""
    names = {f.name for f in dataclasses.fields(tesm.ESM2Config)}
    base = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k in names and k != "dtype"}
    base.update(dtype=torch.float32, **kw)
    return tesm.ESM2Config(**base)


def _tokens(rng, B, S, n_res, *, masks=0):
    toks = np.full((B, S), jesm.PAD_IDX, np.int32)
    for i, n in enumerate(n_res):
        toks[i, 0] = jesm.CLS_IDX
        toks[i, 1:n + 1] = rng.integers(4, 24, n)
        toks[i, n + 1] = jesm.EOS_IDX
        if masks:
            toks[i, rng.integers(1, n + 1, masks)] = jesm.MASK_IDX
    return toks


def test_forward_matches_reference_with_logits():
    """Separate q/k/v, attn_backend "ref", <mask> tokens (pad-aware token
    dropout), MLM logits. f32 on both sides; 1e-4 covers the differing
    orders of f32 sums through two layers and the LM head."""
    jcfg = jesm.tiny_config(attn_backend="ref", remat=False)
    params = jesm.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(np.random.default_rng(0), 3, 24, (20, 9, 14), masks=2)
    want = jesm.forward(params, jcfg, jnp.asarray(toks), return_logits=True)
    got = tesm.forward(bridge.to_torch(params), _port_cfg(jcfg),
                       torch.from_numpy(toks), return_logits=True)
    for key in ("hidden", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dim,n_heads", [(128, 2), (64, 4)])
def test_rowblock_unpadded_route_matches_reference(monkeypatch, dim,
                                                   n_heads):
    """Separate q/k/v with attn_backend "rowblock" at S = 40 (not a multiple
    of 128): the reference pads to 128 and runs the Pallas row-block kernel
    (packed at H*D = 128, rowblock_fwd at H*D = 64); the port runs its
    row-block wrapper on the unpadded rows. Tolerance 1e-4 as above."""
    orig = jesm.flash_attention

    def interpret(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jesm, "flash_attention", interpret)
    jcfg = jesm.tiny_config(attn_backend="rowblock", remat=False, dim=dim,
                            n_heads=n_heads)
    params = jesm.init_params(jax.random.PRNGKey(1), jcfg)
    toks = _tokens(np.random.default_rng(1), 2, 40, (38, 17))
    want = np.asarray(jesm.forward(params, jcfg, jnp.asarray(toks))["hidden"])
    got = tesm.forward(bridge.to_torch(params), _port_cfg(jcfg),
                       torch.from_numpy(toks))["hidden"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_hf_golden_logits():
    """The esm2_tiny HF golden, converted by the reference's converter and
    bridged, at the 3e-4 of tests/test_goldens.py. The capture follows the
    full-length token-dropout semantics; only valid positions count."""
    blob = np.load(GOLDEN)
    sd = {k[3:]: blob[k] for k in blob.files if k.startswith("sd/")}
    jcfg = jesm.ESM2Config(vocab_size=33, dim=64, n_layers=2, n_heads=4,
                           max_seq_len=130, dtype=jnp.float32,
                           attn_backend="ref", remat=False,
                           pad_aware_token_dropout=False)
    params = bridge.to_torch(checkpoint_io.convert_hf_esm2(sd, jcfg))
    out = tesm.forward(params, _port_cfg(jcfg),
                       torch.from_numpy(blob["tokens"]), return_logits=True)
    valid = blob["tokens"] != jesm.PAD_IDX
    np.testing.assert_allclose(out["logits"].numpy()[valid],
                               blob["logits"][valid], atol=3e-4, rtol=3e-4)


def test_bridge_keeps_bf16_bits_and_quantized_form():
    jcfg = jesm.tiny_config(dtype=jnp.bfloat16)
    params = jesm.init_params(jax.random.PRNGKey(2), jcfg)
    q = jesm.fuse_qkv_params(jesm.quantize_params(params, jcfg))
    t = bridge.to_torch(q)
    w = t["layers"]["mlp"]["b1"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(q["layers"]["mlp"]["b1"], np.float32))
    wqkv = t["layers"]["attn"]["wqkv"]
    assert set(wqkv) == {"q", "s"} and wqkv["q"].dtype == torch.int8
    assert wqkv["s"].dtype == torch.float32
    np.testing.assert_array_equal(wqkv["q"].numpy(),
                                  np.asarray(q["layers"]["attn"]["wqkv"]["q"]))


def test_port_quantize_and_fuse_match_reference():
    """quantize_params + fuse_qkv_params in the port give the reference's
    codes and layout from the same bridged weights."""
    jcfg = jesm.tiny_config()
    params = jesm.init_params(jax.random.PRNGKey(3), jcfg)
    want = jesm.fuse_qkv_params(jesm.quantize_params(params, jcfg))
    got = tesm.fuse_qkv_params(tesm.quantize_params(
        bridge.to_torch(params), _port_cfg(jcfg)))
    for grp, name in (("attn", "wqkv"), ("attn", "wo"), ("mlp", "w1")):
        np.testing.assert_array_equal(
            got["layers"][grp][name]["q"].numpy(),
            np.asarray(want["layers"][grp][name]["q"]))
    np.testing.assert_array_equal(got["layers"]["attn"]["bqkv"].numpy(),
                                  np.asarray(want["layers"]["attn"]["bqkv"]))


def test_port_init_params_shapes_and_scales():
    cfg = tesm.tiny_config(dim=128, n_heads=2)
    p = tesm.init_params(0, cfg, device="cpu")
    ref = jesm.init_params(jax.random.PRNGKey(0),
                           jesm.tiny_config(dim=128, n_heads=2))
    flat_t = jax.tree_util.tree_leaves_with_path(bridge.to_numpy(p))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        assert leaf.shape == flat_j[path].shape, path
        assert abs(float(np.std(leaf)) - float(np.std(flat_j[path]))) \
            <= 0.2 * float(np.std(flat_j[path])) + 1e-6, path


@pytest.mark.parametrize("kw", [dict(prefix_len=2), dict(adapter_rank=4),
                                dict(lora=object())])
def test_unported_features_raise(kw):
    cfg = tesm.tiny_config(**kw)
    with pytest.raises(NotImplementedError):
        tesm.init_params(0, cfg, device="cpu")
