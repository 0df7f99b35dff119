"""procyon_tpu_torch's retrieval evaluation against procyon_tpu's on the
CPU: the host code (target sets, label matrices with the NaN leak mask,
train-leak pairs, the max_num_queries subsample and its remap of leak rows,
the prediction cache), the five simple baselines' score matrices and
predictions, calc_retrieval_metrics on one score matrix (within 1e-12), and
ProcyonRetrievalEval's cosine matrix on a tiny fusion model (JAX
init_params carried across by the bridge, f32) within 1e-4 of the JAX
wrapper's, with frozen protein tables and with a tiny live ESM2. Score
matrices are compared here, not rank metrics: a 1e-6 difference can swap
tied ranks.
"""

import os
import pickle

import jax
import numpy as np
import pytest

import procyon_tpu.models.unified as juni
from procyon_tpu.data import collators as jC
from procyon_tpu.data import datasets as jD
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu.evaluate import baselines as jb
from procyon_tpu.evaluate import procyon_models as jpm
from procyon_tpu.evaluate import retrieval as jret
from procyon_tpu.evaluate import utils as jutils
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data import collators as tC
from procyon_tpu_torch.data import datasets as tD
from procyon_tpu_torch.data import instruct as tinstruct
from procyon_tpu_torch.data.text_tokenizer import load_tokenizer as \
    tload_tokenizer
from procyon_tpu_torch.evaluate import baselines as tb
from procyon_tpu_torch.evaluate import procyon_models as tpm
from procyon_tpu_torch.evaluate import retrieval as tret
from procyon_tpu_torch.evaluate import utils as tutils
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_eval_common import (ESM_DIM, ESM_MAX_LEN, TABLE_DIM, VOCAB,
                               tiny_configs)

N_PROTEINS = 48
TEXTS = list(range(100, 112))


def _relations(seed):
    rng = np.random.default_rng(seed)
    rel = sorted({(int(rng.integers(0, N_PROTEINS)), int(rng.choice(TEXTS)))
                  for _ in range(60)})
    half = len(rel) // 2
    return rel[:half], rel[half:]          # train, eval


@pytest.mark.parametrize("subset", [None, [5, 3, 3, 40, 7]])
def test_get_target_set_matches_reference(subset):
    _, ev = _relations(0)
    cfgs = [m.RetrievalEvalConfig(target_subset=subset) for m in (tret, jret)]
    ids = list(range(N_PROTEINS))
    assert tret.get_target_set(ids, ev, cfgs[0]) \
        == jret.get_target_set(ids, ev, cfgs[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_labels_and_leak_pairs_match_reference(seed):
    train, ev = _relations(seed)
    queries = TEXTS[::-1]
    targets = list(range(N_PROTEINS))[::2] + [1, 3]
    leaks = tutils.get_train_relations_for_eval(train, queries, targets)
    assert leaks == jutils.get_train_relations_for_eval(train, queries,
                                                        targets)
    got = tret.prep_for_retrieval_eval(ev, queries, targets, leaks)
    want = jret.prep_for_retrieval_eval(ev, queries, targets, leaks)
    np.testing.assert_array_equal(got, want)       # NaN where leaked
    assert np.isnan(got).sum() == len(leaks) > 0


class _Recording:
    """A retrieval model whose scores are a fixed function of the ids; it
    records the query and target orders it was asked for."""

    name = "recording"

    def __init__(self):
        self.calls = []

    def get_predictions(self, query_order, target_order, dataset=None):
        self.calls.append((list(query_order), list(target_order)))
        q = np.asarray(query_order, float)[:, None]
        t = np.asarray(target_order, float)[None, :]
        return np.sin(q * 1.3 + t * 0.7).astype(np.float32)


@pytest.mark.parametrize("max_q", [None, 5, 11])
def test_run_retrieval_eval_subsample_and_leak_remap_match_reference(
        max_q, monkeypatch):
    train, ev = _relations(2)
    ids = list(range(N_PROTEINS))
    leaks = jutils.get_train_relations_for_eval(train, TEXTS, ids)
    seen = {}
    for name, mod in (("port", tret), ("jax", jret)):
        labels_of = mod.prep_for_retrieval_eval

        def spy(*a, _name=name, _f=labels_of):
            seen.setdefault(_name, []).append(_f(*a))
            return seen[_name][-1]

        monkeypatch.setattr(mod, "prep_for_retrieval_eval", spy)
        model = _Recording()
        cfg = mod.RetrievalEvalConfig(max_num_queries=max_q,
                                      query_subsample_seed=3, n_boot=20)
        seen[name + "_metrics"] = mod.run_retrieval_eval(
            model, None, all_protein_ids=ids, eval_relations=ev,
            query_order=TEXTS, cfg=cfg, train_leak_pairs=set(leaks))
        seen[name + "_calls"] = model.calls
    assert seen["port_calls"] == seen["jax_calls"]
    assert len(seen["port_calls"][0][0]) == (max_q or len(TEXTS))
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    assert seen["port_metrics"].keys() == seen["jax_metrics"].keys()
    for k, v in seen["jax_metrics"].items():
        assert seen["port_metrics"][k] == pytest.approx(v, abs=1e-12,
                                                        nan_ok=True), k


def test_prediction_cache_round_trip_both_ways(tmp_path):
    preds = np.random.default_rng(0).random((3, 5)).astype(np.float32)
    q, t = [7, 8, 9], [1, 2, 3, 4, 5]
    tcache = tutils.PredictionCache(str(tmp_path / "port"))
    jcache = jutils.PredictionCache(str(tmp_path / "jax"))
    tcache.save("m", "d", preds, q, t)
    jcache.save("m", "d", preds, q, t)
    for name in os.listdir(tmp_path / "port"):
        with open(tmp_path / "port" / name, "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "jax" / name, "rb") as f:
            b = pickle.load(f)
        assert a.keys() == b.keys() and a["query_order"] == b["query_order"] \
            and a["target_order"] == b["target_order"]
        np.testing.assert_array_equal(a["predictions"], b["predictions"])
    # each package reads the other's file
    np.testing.assert_array_equal(
        tutils.PredictionCache(str(tmp_path / "jax")).load("m", "d", q, t),
        preds)
    np.testing.assert_array_equal(
        jutils.PredictionCache(str(tmp_path / "port")).load("m", "d", q, t),
        preds)
    with pytest.raises(ValueError, match="query order"):
        tcache.load("m", "d", [9, 8, 7], t)
    with pytest.raises(ValueError, match="target order"):
        tcache.load("m", "d", q, t[::-1])
    assert tcache.load("m", "other") is None
    assert tutils.PredictionCache(None).load("m", "d") is None


def test_write_and_read_metrics(tmp_path):
    for mod in (tutils, jutils):
        out = str(tmp_path / mod.__name__)
        mod.write_metrics(out, "retrieval", "knn", "d1", {"auroc": 0.75})
        mod.write_metrics(out, "retrieval", "mlp", "d1", {"auroc": 0.5,
                                                          "auprc": 0.25})
    with open(tmp_path / tutils.__name__ / "retrieval_metrics.tsv") as f:
        port = f.read()
    with open(tmp_path / jutils.__name__ / "retrieval_metrics.tsv") as f:
        assert port == f.read()
    assert tutils.read_metrics(str(tmp_path / tutils.__name__),
                               "retrieval")[2] == {
        "model": "mlp", "dataset": "d1", "metric": "auprc", "value": 0.25}


def _embeddings(seed, dim=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, dim)) * 3
    return {a: centers[a % 3] + rng.standard_normal(dim) * 0.5
            for a in range(N_PROTEINS)}


def _baseline_pairs(train):
    emb = _embeddings(4)
    S = np.random.default_rng(5).standard_normal((N_PROTEINS + 2,
                                                  N_PROTEINS + 2))
    index = {a: N_PROTEINS + 1 - a for a in range(N_PROTEINS)}
    return [
        ("knn", lambda m: m.KNNRetrievalModel(emb, train, k=3)),
        ("mlp", lambda m: m.MLPRetrievalModel(emb, train, epochs=20)),
        ("blast", lambda m: m.ScoreMatrixRetrievalModel(S, index, train)),
        ("random", lambda m: m.RandomRetrievalModel(seed=3)),
    ]


@pytest.mark.parametrize("name", ["knn", "mlp", "blast", "random"])
def test_retrieval_baselines_match_reference(name):
    train, ev = _relations(6)
    make = dict(_baseline_pairs(train))[name]
    targets = list(range(N_PROTEINS))[::-1]
    got = make(tb).get_predictions(TEXTS, targets)
    want = make(jb).get_predictions(TEXTS, targets)
    assert got.dtype == want.dtype and got.shape == (len(TEXTS),
                                                     N_PROTEINS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["knn", "random"])
def test_qa_baselines_match_reference(name):
    train, ev = _relations(7)
    samples = [(a, t, 1) for a, t in ev] + [((a + 5) % N_PROTEINS, t, 0)
                                            for a, t in ev]
    emb = _embeddings(8)
    make = {"knn": lambda m: m.KNNQAModel(emb, train, k=4),
            "random": lambda m: m.RandomQAModel(seed=2)}[name]
    got = make(tb).get_predictions(samples)
    want = make(jb).get_predictions(samples)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_baselines_export_only_the_simple_six():
    """The simple six, and since slice 6b the text-encoder and ProtLLM
    baselines too: the JAX package's exports, name for name."""
    simple = ["KNNRetrievalModel", "KNNQAModel", "MLPRetrievalModel",
              "RandomRetrievalModel", "RandomQAModel",
              "ScoreMatrixRetrievalModel"]
    assert set(simple) <= set(tb.__all__)
    assert sorted(tb.__all__) == sorted(jb.__all__)


@pytest.mark.parametrize("seed", [0, 1])
def test_calc_retrieval_metrics_matches_reference(seed):
    train, ev = _relations(seed)
    ids = list(range(N_PROTEINS))
    leaks = jutils.get_train_relations_for_eval(train, TEXTS, ids)
    labels = jret.prep_for_retrieval_eval(ev, TEXTS, ids, leaks)
    scores = _Recording().get_predictions(TEXTS, ids) \
        + np.random.default_rng(seed).standard_normal(labels.shape)
    kw = dict(top_ks=(1, 5, 30), num_resamples=3, negs_per_pos=4, n_boot=40)
    got = tret.calc_retrieval_metrics(labels, scores,
                                      tret.RetrievalEvalConfig(**kw))
    want = jret.calc_retrieval_metrics(labels, scores,
                                       jret.RetrievalEvalConfig(**kw))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


# ---------------------------------------------------------------------------
# ProcyonRetrievalEval on a tiny fusion model
# ---------------------------------------------------------------------------


def _retrieval_models(live_esm, tmp_path=None):
    jcfg, tcfg = tiny_configs(live_esm)
    params = juni.init_params(jax.random.PRNGKey(11), jcfg)
    dim = ESM_DIM if live_esm else TABLE_DIM
    task = "disgenet_all_retrieval"
    kw = dict(batch_size=3)
    ccfg = dict(protein_embed_dim=dim, max_protein_len=ESM_MAX_LEN)
    jmodel = jpm.ProcyonRetrievalEval(
        params, jcfg, jload_tokenizer(vocab_size=VOCAB),
        jD.SyntheticStore(n_proteins=N_PROTEINS, embed_dim=dim),
        jinstruct.TaskLibrary().get(task),
        collator_cfg=jC.CollatorConfig(**ccfg), **kw)
    tmodel = tpm.ProcyonRetrievalEval(
        bridge.to_torch(params), tcfg, tload_tokenizer(vocab_size=VOCAB),
        tD.SyntheticStore(n_proteins=N_PROTEINS, embed_dim=dim),
        tinstruct.TaskLibrary().get(task),
        collator_cfg=tC.CollatorConfig(**ccfg), device="cpu",
        target_cache_path=None if tmp_path is None
        else str(tmp_path / "targets.pkl"), **kw)
    return jmodel, tmodel


@pytest.mark.parametrize("live_esm", [False, True])
def test_procyon_retrieval_eval_matches_reference(live_esm):
    jmodel, tmodel = _retrieval_models(live_esm)
    queries = [3, 17, 5, 60, 9, 21, 40]           # 3 batches, one ragged
    targets = list(range(N_PROTEINS))[::-1]
    want = np.asarray(jmodel.get_predictions(queries, targets))
    got = tmodel.get_predictions(queries, targets)
    assert got.dtype == np.float32 and got.shape == want.shape \
        == (len(queries), N_PROTEINS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the cosine matrix of the port's own embeddings
    q = tmodel.query_embeddings(queries).numpy()
    t = tmodel.target_embeddings(targets)
    cos = (q / np.linalg.norm(q, axis=1, keepdims=True)) \
        @ (t / np.linalg.norm(t, axis=1, keepdims=True)).T
    np.testing.assert_allclose(got, cos, atol=1e-6, rtol=0)


def test_procyon_retrieval_target_cache(tmp_path):
    _, tmodel = _retrieval_models(False, tmp_path)
    targets = list(range(0, N_PROTEINS, 2))
    first = tmodel.target_embeddings(targets)
    with open(tmp_path / "targets.pkl", "rb") as f:
        blob = pickle.load(f)
    assert blob["order"] == targets
    np.testing.assert_array_equal(blob["embeds"], first)
    # a cached table is read back while the order matches, and rebuilt when
    # it does not
    blob["embeds"] = blob["embeds"] + 1.0
    with open(tmp_path / "targets.pkl", "wb") as f:
        pickle.dump(blob, f)
    np.testing.assert_array_equal(tmodel.target_embeddings(targets),
                                  first + 1.0)
    np.testing.assert_array_equal(tmodel.target_embeddings(targets[::-1]),
                                  first[::-1])


def test_procyon_retrieval_eval_refuses_another_device():
    jcfg, tcfg = tiny_configs()
    params = bridge.to_torch(juni.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="device"):
        tpm.ProcyonRetrievalEval(
            params, tcfg, tload_tokenizer(vocab_size=VOCAB),
            tD.SyntheticStore(n_proteins=4, embed_dim=TABLE_DIM),
            tinstruct.TaskLibrary().get("disgenet_all_retrieval"))
