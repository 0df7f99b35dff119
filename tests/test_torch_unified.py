"""The slice as a whole: procyon_tpu_torch's protein embedding path
(tokenize -> ESM2 -> pool -> regroup chunks -> shared projector -> cosine
top-k) against procyon_tpu's on the CPU in f32, with the reference's
parameters carried across through the bridge.

The W8A8 serving case takes both kernels' routes on both sides: the packed
row-block attention (S = 128, H*D = 128) and the fused LN + int8 MLP
(B*S = 512, ffn = 512). The reference reaches its Pallas kernels in
interpret mode through wrappers patched in for this test only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.esm2 as jesm
import procyon_tpu.models.unified as juni
import procyon_tpu.ops.attention_rowblock as jrb
import procyon_tpu.ops.fused_mlp as jfm
from procyon_tpu.data import protein_tokenizer as jtok
from procyon_tpu.inference.prompts import get_proteins_from_embedding as jtopk
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data import protein_tokenizer as ttok
from procyon_tpu_torch.inference.prompts import \
    get_proteins_from_embedding as ttopk
from procyon_tpu_torch.models import esm2 as tesm
from procyon_tpu_torch.models import unified as tuni

# three proteins, one of them split over two rows: 4 rows of width 128
SEQS = ["MKTAYIAKQRQISFVKSHFSRQ" * 5,
        "GAVLIPFMWSTCYNQDEKRH" * 10,
        "MSEEKLKQLLEG" * 4]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the reference's two Pallas kernels in interpret mode."""
    packed = jrb.rowblock_packed_qkv_fwd
    fused = jfm.fused_ln_mlp_int8

    def packed_i(qkv, seg, positions, cfg, **kw):
        return packed(qkv, seg, positions, (cfg[0], cfg[1], True, cfg[3]),
                      **kw)

    def fused_i(*a, **kw):
        kw["interpret"] = True
        return fused(*a, **kw)

    monkeypatch.setattr(jrb, "rowblock_packed_qkv_fwd", packed_i)
    monkeypatch.setattr(jfm, "fused_ln_mlp_int8", fused_i)


def _configs(**esm_kw):
    ecfg = jesm.tiny_config(dim=128, n_heads=2, n_layers=2, max_seq_len=256,
                            remat=False, **esm_kw)
    jcfg = juni.tiny_config(esm=ecfg)
    names = {f.name for f in dataclasses.fields(tesm.ESM2Config)}
    tecfg = tesm.ESM2Config(**{k: v for k, v in dataclasses.asdict(
        ecfg).items() if k in names and k != "dtype"},
        dtype=torch.float32)
    layers = jcfg.shared_projector_layers or jcfg.retrieval_projector_layers
    tcfg = tuni.UnifiedConfig(
        llama=None, esm=tecfg, retrieval_dim=jcfg.retrieval_dim,
        shared_projector_layers=layers,
        shared_projector_hidden=jcfg.shared_projector_hidden,
        protein_pooling=jcfg.protein_pooling, dtype=torch.float32)
    return jcfg, tcfg


def _embed_both(jcfg, tcfg, serving):
    params = juni.init_params(jax.random.PRNGKey(0), jcfg)
    if serving:
        params["esm"] = jesm.fuse_qkv_params(
            jesm.quantize_params(params["esm"], jcfg.esm))
    pb = jtok.batch_encode(SEQS, max_len=126)
    assert pb.tokens.shape == (4, 128) and pb.num_groups == 3
    want = juni.target_protein_embeddings(params, jcfg, juni.encode_proteins(
        params, jcfg, jnp.asarray(pb.tokens),
        group_ids=jnp.asarray(pb.group_ids), num_groups=pb.num_groups,
        row_valid=jnp.asarray(pb.row_valid)))
    tparams = bridge.to_torch({
        "esm": params["esm"],
        "projectors": {"shared_projector":
                       params["projectors"]["shared_projector"]}})
    tb = ttok.batch_encode(SEQS, max_len=126)
    np.testing.assert_array_equal(tb.tokens, pb.tokens)
    fn = tuni.protein_embed_fn(tcfg)
    got = fn(tparams, torch.from_numpy(tb.tokens),
             torch.from_numpy(tb.group_ids), torch.from_numpy(tb.row_valid),
             tb.num_groups)
    return got.numpy(), np.asarray(want)


def test_w8a8_serving_slice_matches_reference(pallas_interpret):
    """Fused QKV + W8A8 + both kernels' routes. An int8 rounding tie that
    flips one code shifts its row by one quantization step, so the bound is
    2e-3 on unit-scale embeddings; in the common case they agree to 1e-5
    (checked loosely through the median)."""
    jcfg, tcfg = _configs(attn_backend="rowblock", quant_mode="w8a8")
    got, want = _embed_both(jcfg, tcfg, serving=True)
    assert got.shape == want.shape == (3, jcfg.retrieval_dim)
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= 2e-3, err.max()
    assert np.median(err) <= 1e-5, np.median(err)


def test_f32_slice_matches_reference():
    """Unquantized separate q/k/v, plain attention on both sides
    ("ref"); 1e-4 covers f32 sum order through the stack."""
    jcfg, tcfg = _configs(attn_backend="ref")
    got, want = _embed_both(jcfg, tcfg, serving=False)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_topk_ranking_matches_reference(pallas_interpret):
    """Cosine top-k over the slice's embeddings: the port's ranking equals
    the reference's get_proteins_from_embedding on the reference's own
    embeddings, and each protein ranks itself first."""
    jcfg, tcfg = _configs(attn_backend="rowblock", quant_mode="w8a8")
    got, want = _embed_both(jcfg, tcfg, serving=True)
    for i in range(len(SEQS)):
        rt = ttopk(got, got[i], top_k=3)
        rj = jtopk(want, want[i], top_k=3)
        assert [r["protein_id"] for r in rt] == [r["protein_id"] for r in rj]
        assert rt[0]["protein_id"] == i
        assert abs(rt[0]["score"] - 1.0) < 1e-5


def test_pooling_and_regroup_match_reference():
    from procyon_tpu.models import pooling as jpool
    from procyon_tpu_torch.models import pooling as tpool
    rng = np.random.default_rng(0)
    h = rng.standard_normal((5, 7, 8)).astype(np.float32)
    mask = (rng.random((5, 7)) > 0.3).astype(np.int32)
    gid = np.array([0, 0, 1, 2, 2], np.int32)
    valid = np.array([1, 1, 1, 1, 0], np.float32)
    for method in ("mean", "max", "cls"):
        want = jpool.pool_tokens(jnp.asarray(h), jnp.asarray(mask), method)
        got = tpool.pool_tokens(torch.from_numpy(h), torch.from_numpy(mask),
                                method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        if method == "cls":
            continue
        want = jpool.regroup_chunks(want, jnp.asarray(gid), 3,
                                    row_valid=jnp.asarray(valid),
                                    method=method)
        got = tpool.regroup_chunks(got, torch.from_numpy(gid), 3,
                                   row_valid=torch.from_numpy(valid),
                                   method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_projector_matches_reference(n_layers):
    """1 layer: bias-free; deeper: bias + exact GELU between layers."""
    from procyon_tpu.models import projectors as jproj
    from procyon_tpu_torch.models import projectors as tproj
    jc = jproj.ProjectorConfig(in_dim=16, out_dim=8, n_layers=n_layers,
                               hidden_dim=12, dtype=jnp.float32)
    tc = tproj.ProjectorConfig(in_dim=16, out_dim=8, n_layers=n_layers,
                               hidden_dim=12, dtype=torch.float32)
    params = jproj.init_params(jax.random.PRNGKey(0), jc)
    params = [{k: v + 0.1 for k, v in layer.items()} for layer in params]
    x = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    want = jproj.apply(params, jc, jnp.asarray(x))
    got = tproj.apply(bridge.to_torch(params), tc, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert all(("b" in p) == (n_layers > 1)
               for p in tproj.init_params(0, tc, device="cpu"))
