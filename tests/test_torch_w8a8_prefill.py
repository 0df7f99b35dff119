"""The W8A8 prefill entry points of procyon_tpu_torch (scripts/bench_bind,
bench_retrieval, bench_prefill) against procyon_tpu's unified.forward /
llama.forward on the CPU in f32, on the reference's int8 parameters
(llama.quantize_params) carried across through the bridge: the bench
decoder's shape cut to dim 128 and 2 layers (vocabulary 32000, the
2560-wide peptide embeddings and 3-layer token projector kept), W8A8.

Tolerances: the yes-probabilities, query embeddings and W8A8 logits within
2e-3 (an activation's int8 code can take the neighbouring value at a
rounding tie, which moves its row by one quantization step; in the common
case they agree to 1e-5, checked through the median); the weight-only
logits within 1e-4 (f32 sums in another order). The retrieval top-10: the
reference's score of each of the port's ten within one bf16 step (2^-7) of
the reference's tenth, since the scores are bf16 and can tie.
Also: each script's CLI with --device cpu prints its JSON line, untimed.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.contrastive as jcon
import procyon_tpu.models.llama as jllama
import procyon_tpu.models.unified as juni
from procyon_tpu_torch import bridge
from procyon_tpu_torch.scripts import bench_bind, bench_prefill, \
    bench_retrieval
from torch_cpu_common import one_torch_thread  # noqa: F401

ATOL_W8A8 = 2e-3
MEDIAN = 1e-5
B, L = 4, 32


def _jax_config(tcfg):
    lc = tcfg.llama
    jl = jllama.LlamaConfig(**{
        f.name: getattr(lc, f.name) for f in dataclasses.fields(lc)
        if f.name not in ("dtype", "lora")}, dtype=jnp.float32)
    return juni.UnifiedConfig(**{
        f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
        if f.name not in ("llama", "contrastive", "dtype")},
        llama=jl, contrastive=jcon.InfoNCEConfig(), dtype=jnp.float32)


@pytest.fixture(scope="module")
def models():
    tcfg = bench_bind.bind_config(dim=128, layers=2, prompt_len=L,
                                  dtype=torch.float32, attn_backend="ref")
    jcfg = _jax_config(tcfg)
    jp = dict(juni.init_params(jax.random.PRNGKey(7), jcfg))
    jp["llama"] = jllama.quantize_params(jp["llama"], jcfg.llama)
    return jcfg, jp, tcfg, bridge.to_torch(jp)


def _jnp(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _close_w8a8(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= ATOL_W8A8, err.max()
    assert np.median(err) <= MEDIAN, np.median(err)


def test_bind_yes_probabilities(models):
    jcfg, jp, tcfg, tp = models
    batch = bench_bind.bind_batch(tcfg, B, L, "cpu")
    got = bench_bind.yes_prob(tp, tcfg, batch).numpy()
    jb = _jnp({k: v for k, v in batch.items() if k != "answer_pos"})
    logits = jax.jit(lambda p, b: juni.forward(p, jcfg, b)["logits"])(jp, jb)
    two = np.asarray(logits)[:, L - 1][:, [bench_bind.YES_ID,
                                           bench_bind.NO_ID]]
    want = np.asarray(jax.nn.softmax(jnp.asarray(two), axis=-1))[:, 0]
    assert got.shape == (B,) and np.isfinite(got).all()
    _close_w8a8(got, want)


def test_retrieval_embeddings_and_top10(models):
    jcfg, jp, tcfg, tp = models
    batch, targets = bench_retrieval.retrieval_batch(tcfg, B, L, 500, "cpu")
    q, vals, ids = bench_retrieval.retrieve(tp, tcfg, batch, targets)
    jq = np.asarray(jax.jit(lambda p, b: juni.retrieval_query_embedding(
        p, jcfg, b))(jp, _jnp(batch)))
    _close_w8a8(q.numpy(), jq)
    t = jnp.asarray(targets.float().numpy(), jnp.bfloat16)
    scores = np.asarray((jnp.asarray(jq).astype(jnp.bfloat16) @ t.T)
                        .astype(jnp.float32))
    tenth = np.sort(scores, -1)[:, -10]
    picked = np.take_along_axis(scores, ids.numpy(), -1)
    assert (picked >= tenth[:, None] - 2.0 ** -7 * np.abs(tenth)[:, None]
            ).all()
    np.testing.assert_allclose(vals.numpy(), np.sort(scores, -1)[:, ::-1][
        :, :10], rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("mode", bench_prefill.MODES)
def test_prefill_logits(models, mode):
    jcfg, jp, tcfg, tp = models
    tokens = bench_prefill.prefill_tokens(tcfg.llama, B, L, "cpu")
    got = bench_prefill.prefill_logits(tp["llama"], tcfg.llama, tokens,
                                       mode).numpy()
    c = dataclasses.replace(jcfg.llama, quant_mode=mode)
    want = np.asarray(jax.jit(lambda p, t: jllama.forward(
        p, c, tokens=t)["logits"][:, -1])(jp["llama"],
                                          jnp.asarray(tokens.numpy())))
    assert got.shape == (B, tcfg.llama.vocab_size)
    if mode == "w8a8":
        _close_w8a8(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("script,extra", [
    (bench_bind, []), (bench_retrieval, ["--n_targets", "100"]),
    (bench_prefill, None)])
def test_cli_runs_untimed_on_the_cpu(capsys, script, extra):
    if extra is None:
        argv = ["--seq", "16"]
    else:
        argv = ["--prompt_len", "16", *extra]
    res = script.main(["--device", "cpu", "--dim", "128", "--layers", "2",
                       "--batch", "2", *argv])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["finite"] and line["timed"] is False
    assert line == res["line"]
    assert line["metric"].endswith("_per_sec_chip")
