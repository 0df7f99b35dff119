"""scripts/bench_w8a8.py of the port against the JAX package on the CPU:
the token batch is the reference script's for the same seed; on the
reference's tiny ESM2 (dim 128, 2 heads, 2 layers, rows of 128 tokens)
with its parameters bridged, the two timed routes' embeddings (unquantized
with q / k / v apart; int8 W8A8 with fused QKV through both kernels'
routes, the reference's Pallas kernels in interpret mode) and the W8A8 vs
unquantized cosine agree with the reference's mean-pooled embeddings; the
CLI's untimed run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.esm2 as jesm
import procyon_tpu.ops.attention_rowblock as jrb
import procyon_tpu.ops.fused_mlp as jfm
from procyon_tpu.models.pooling import pool_tokens
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import esm2 as tesm
from procyon_tpu_torch.scripts import bench_w8a8
from torch_bench_common import jax_script, last_json
from torch_cpu_common import one_torch_thread  # noqa: F401

JAX_SCRIPT = jax_script("bench_w8a8")
B, S = 4, 128


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The reference's two Pallas kernels in interpret mode."""
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


@pytest.mark.parametrize("batch,seq_len,seed", [(64, 512, 0), (5, 40, 3)])
def test_tokens_are_the_references(batch, seq_len, seed):
    got = bench_w8a8.tokens_batch(batch, seq_len, seed, device="cpu")
    want = np.asarray(JAX_SCRIPT.tokens_batch(batch, seq_len, seed))
    np.testing.assert_array_equal(got.numpy(), want)


def test_embeddings_and_cosine_match_reference(pallas_interpret):
    """Unquantized route within 1e-4 (f32 sum order); the W8A8 route within
    2e-3 (an int8 rounding tie flips one code and moves its row by one
    step), and the cosine between the two within 1e-4 of the reference's
    per protein."""
    jcfg = jesm.tiny_config(dim=128, n_heads=2, n_layers=2, max_seq_len=S,
                            remat=False, attn_backend="rowblock")
    jparams = jesm.init_params(jax.random.PRNGKey(1), jcfg)
    toks = JAX_SCRIPT.tokens_batch(B, S, seed=2)
    mask = (toks != jesm.PAD_IDX).astype(jnp.int32)

    def embed(p, c):
        return np.asarray(pool_tokens(jesm.forward(p, c, toks)["hidden"],
                                      mask, "mean"), np.float32)

    want = embed(jparams, dataclasses.replace(jcfg, attn_backend="ref"))
    qp = jesm.fuse_qkv_params(jesm.quantize_params(jparams, jcfg))
    want8 = embed(qp, dataclasses.replace(jcfg, quant_mode="w8a8"))

    names = {f.name for f in dataclasses.fields(tesm.ESM2Config)}
    tcfg = tesm.ESM2Config(**{k: v for k, v in dataclasses.asdict(
        jcfg).items() if k in names and k != "dtype"}, dtype=torch.float32)
    tparams = bridge.to_torch(jparams)
    res = bench_w8a8.run(tparams, tcfg, device="cpu",
                         tokens=torch.from_numpy(np.array(toks)))
    got = res["embeddings"]["bf16"].numpy()
    got8 = res["embeddings"]["w8a8"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(got8 - want8).max() <= 2e-3
    cos = (want * want8).sum(1) / (np.linalg.norm(want, axis=1)
                                   * np.linalg.norm(want8, axis=1))
    assert abs(res["cos_min"] - cos.min()) <= 1e-4
    assert abs(res["cos_mean"] - cos.mean()) <= 1e-4
    assert res["finite"] and res["line"]["timed"] is False


def test_cli_runs_untimed_on_the_cpu(capsys):
    res = bench_w8a8.main(["--device", "cpu", "--size", "8m", "--batch",
                           "3", "--seq_len", "64"])
    line = last_json(capsys)
    assert line == res["line"] and line["timed"] is False
    assert line["metric"] == "esm2_w8a8_proteins_per_sec_chip"
    assert line["value"] is None and 0.99 <= line["w8a8_vs_bf16_cos_min"]
    assert tuple(res["embeddings"]["w8a8"].shape) == (3, 320)
