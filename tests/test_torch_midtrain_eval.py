"""procyon_tpu_torch's mid-train evaluation (training/evaluation.py)
against procyon_tpu's on the CPU, and run_pretrain --eval_steps.

build_midtrain_eval on the JAX init_params carried across by the bridge
(f32), both fed the same val-split batches (drawn once from the JAX
package's synthetic streams and replayed to each): the QA and caption val
metrics within 1e-4, retrieval AUROC / AUPRC equal (the cosine scores
agree to 1e-4, and the ranks with them), and the early-stopping "loss".
all_protein_target_embeddings within 1e-4 with frozen tables and with a
tiny live ESM2. When no val positive is among the targets (the capped
target set), retrieval AUROC / AUPRC and the early-stopping "loss" are NaN
in both packages, and both trainers count such an eval as a bad one.
`run_pretrain --eval_steps 1 --max_steps 2 --device cpu` writes the eval
metrics to metrics.jsonl at every step.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import procyon_tpu.models.unified as juni
from procyon_tpu.data import collators as jC
from procyon_tpu.data import data_config as jdc
from procyon_tpu.data import datasets as jD
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu.training import evaluation as jev
from procyon_tpu.training import trainer as jtrainer
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data import datasets as tD
from procyon_tpu_torch.training import evaluation as tev
from procyon_tpu_torch.training import trainer as ttrainer
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_eval_common import (ESM_DIM, ESM_MAX_LEN, ROOT, TABLE_DIM, VOCAB,
                               tiny_configs)

N_PROTEINS = 32
N_BATCHES = 2


def _val_batches(tasks):
    """N_BATCHES val-split batches a task from the JAX package's synthetic
    streams (the go / process mix, batch 2)."""
    mix = jdc.MultiDatasetConfig(entries=[jdc.DatasetEntry(
        text_type="go", relations=["process"], tasks=list(tasks),
        splits=["val"])])
    streams, _, _ = jdc.build_task_streams(
        mix, store=jD.SyntheticStore(n_proteins=N_PROTEINS, n_texts=32,
                                     embed_dim=TABLE_DIM),
        tokenizer=jload_tokenizer(vocab_size=VOCAB),
        collator_cfg=jC.CollatorConfig(max_text_len=192,
                                       protein_embed_dim=TABLE_DIM),
        batch_sizes={t: 2 for t in tasks}, synthetic=True, seed=7)
    return {t: [streams[t]() for _ in range(N_BATCHES)] for t in tasks}


def _replay(batches):
    return {t: iter(list(bs)).__next__ for t, bs in batches.items()}


def _run_both(batches, ids):
    jcfg, tcfg = tiny_configs()
    params = juni.init_params(jax.random.PRNGKey(5), jcfg)
    jfn = jev.build_midtrain_eval(
        jcfg, val_streams=_replay(batches),
        store=jD.SyntheticStore(n_proteins=N_PROTEINS, embed_dim=TABLE_DIM),
        all_protein_ids=ids, n_batches=N_BATCHES,
        to_device=lambda b: {k: jnp.asarray(v) for k, v in b.items()})
    tfn = tev.build_midtrain_eval(
        tcfg, val_streams=_replay(batches),
        store=tD.SyntheticStore(n_proteins=N_PROTEINS, embed_dim=TABLE_DIM),
        all_protein_ids=ids, n_batches=N_BATCHES, device="cpu")
    return tfn(bridge.to_torch(params)), jfn(params)


@pytest.fixture(scope="module")
def both_evals():
    return _run_both(_val_batches(("qa", "retrieval", "caption")),
                     list(range(N_PROTEINS)))


def test_midtrain_eval_reports_the_reference_keys(both_evals):
    got, want = both_evals
    assert got.keys() == want.keys()
    assert {"qa/loss", "caption/loss", "retrieval/auroc", "retrieval/auprc",
            "loss"} <= got.keys()


@pytest.mark.parametrize("key", ["qa/loss", "qa/lm_loss", "qa/qa_acc",
                                 "caption/loss", "caption/token_acc",
                                 "loss"])
def test_midtrain_val_metrics_match_reference(both_evals, key):
    got, want = both_evals
    assert np.isfinite(got[key])
    assert got[key] == pytest.approx(float(want[key]), abs=1e-4)


@pytest.mark.parametrize("key", ["retrieval/auroc", "retrieval/auprc"])
def test_midtrain_retrieval_metrics_equal_reference(both_evals, key):
    got, want = both_evals
    assert 0.0 <= got[key] <= 1.0
    assert got[key] == pytest.approx(want[key], abs=1e-12)


def test_midtrain_eval_is_nan_when_no_val_positive_is_a_target():
    """The reference's behaviour, kept: a val query whose positive lies
    outside all_protein_ids (as past eval_max_target_proteins, the first
    ids) is dropped without notice, and when every one is, retrieval
    AUROC / AUPRC are NaN and so is the early-stopping "loss"."""
    batches = _val_batches(("qa", "retrieval"))
    pos = {int(a) for b in batches["retrieval"]
           for a in b["reference_indices"]["aaseq"]}
    ids = [a for a in range(N_PROTEINS) if a not in pos]
    assert pos and len(ids) >= N_PROTEINS - 2 * N_BATCHES
    with pytest.warns(RuntimeWarning):        # nanmean of NaNs alone
        got, want = _run_both(batches, ids)
    for key in ("retrieval/auroc", "retrieval/auprc", "loss"):
        assert np.isnan(got[key]) and np.isnan(float(want[key])), key
    assert np.isfinite(got["qa/loss"])
    assert got["qa/loss"] == pytest.approx(float(want["qa/loss"]), abs=1e-4)


@pytest.mark.parametrize("trainer", [jtrainer.Trainer, ttrainer.Trainer],
                         ids=["reference", "port"])
def test_trainer_counts_a_nan_eval_as_bad(trainer, tmp_path):
    """NaN < best is False: a NaN eval "loss" counts as no improvement in
    both packages, so patience runs out on NaN evals alone."""
    state = types.SimpleNamespace(
        loop=types.SimpleNamespace(early_stopping_patience=2,
                                   early_stopping_metric="eval/loss",
                                   output_dir=str(tmp_path)),
        _best=np.inf, _bad_evals=0, global_step=1)
    assert not trainer._early_stop(state, {"loss": 5.0})
    assert state._best == 5.0 and state._bad_evals == 0
    assert not trainer._early_stop(state, {"loss": float("nan")})
    assert trainer._early_stop(state, {"loss": float("nan")})
    assert state._best == 5.0 and state._bad_evals == 2


@pytest.mark.parametrize("live_esm", [False, True])
def test_all_protein_target_embeddings_match_reference(live_esm):
    jcfg, tcfg = tiny_configs(live_esm)
    params = juni.init_params(jax.random.PRNGKey(6), jcfg)
    dim = ESM_DIM if live_esm else TABLE_DIM
    ids = list(range(N_PROTEINS))[::-1]
    kw = dict(batch=12, max_protein_len=ESM_MAX_LEN)
    want = jev.all_protein_target_embeddings(
        params, jcfg, jD.SyntheticStore(n_proteins=N_PROTEINS,
                                        embed_dim=dim), ids, **kw)
    got = tev.all_protein_target_embeddings(
        bridge.to_torch(params), tcfg,
        tD.SyntheticStore(n_proteins=N_PROTEINS, embed_dim=dim), ids,
        device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == (N_PROTEINS,
                                                     jcfg.retrieval_dim)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_midtrain_eval_refuses_another_device():
    jcfg, tcfg = tiny_configs()
    params = bridge.to_torch(juni.init_params(jax.random.PRNGKey(0), jcfg))
    eval_fn = tev.build_midtrain_eval(tcfg, val_streams={})
    with pytest.raises(ValueError, match="device"):
        eval_fn(params)


def test_run_pretrain_evaluates_every_eval_steps(tmp_path):
    out = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "procyon_tpu_torch.scripts.run_pretrain",
         "--synthetic", "true", "--device", "cpu", "--log_steps", "1",
         "--warmup_steps", "1", "--qa_batch_size", "2",
         "--retrieval_batch_size", "2", "--caption_batch_size", "2",
         "--max_steps", "2", "--eval_steps", "1", "--eval_batches", "2",
         "--output_dir", out],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "final_step": 2, "output_dir": out}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f)
                 if any(k.startswith("eval/") for k in r)]
    assert [r["global_step"] for r in evals] == [1, 2]
    for r in evals:
        assert np.isfinite(r["eval/qa/loss"]) \
            and np.isfinite(r["eval/caption/loss"])
        assert 0.0 <= r["eval/retrieval/auroc"] <= 1.0
        assert 0.0 <= r["eval/retrieval/auprc"] <= 1.0
        assert r["eval/loss"] == pytest.approx(
            r["eval/qa/loss"] + r["eval/caption/loss"]
            - r["eval/retrieval/auprc"], abs=1e-9)
