"""procyon_tpu_torch's QA evaluation against procyon_tpu's and
scikit-learn's: the port's numpy macro-F1 (metrics.f1_macro) against
sklearn.metrics.f1_score(average="macro") on random, tied and one-class
cases and with a class the predictions miss; calc_qa_metrics,
bootstrap_ci and run_qa_eval (through a cache) equal to the reference's;
ProcyonQAEval's yes-probabilities on a tiny fusion model equal to the
reference's within 1e-4 (f32, the fusion tests' tolerance), unquantized
and in W8A8 on the reference's int8 leaves (within 2e-3 there: an
activation's code can flip at a rounding tie).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import f1_score

import procyon_tpu.models.contrastive as jcon
import procyon_tpu.models.llama as jllama
import procyon_tpu.models.unified as juni
from procyon_tpu.data import datasets as jdatasets
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu.evaluate import metrics as jmetrics
from procyon_tpu.evaluate import procyon_models as jpm
from procyon_tpu.evaluate import qa as jqa
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data import datasets as tdatasets
from procyon_tpu_torch.data import instruct as tinstruct
from procyon_tpu_torch.data.text_tokenizer import load_tokenizer as \
    tload_tokenizer
from procyon_tpu_torch.evaluate import metrics as tmetrics
from procyon_tpu_torch.evaluate import procyon_models as tpm
from procyon_tpu_torch.evaluate import qa as tqa
from procyon_tpu_torch.models import contrastive as tcon
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import unified as tuni
from torch_cpu_common import one_torch_thread  # noqa: F401

VOCAB = 512


def _cases():
    rng = np.random.default_rng(0)
    yield rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    yield np.array([1, 1, 1, 1]), np.array([1, 1, 1, 1])      # one class
    yield np.array([0, 0, 0]), np.array([1, 1, 1])             # disjoint
    yield np.array([0, 1, 1, 0, 1]), np.array([1, 1, 1, 1, 1])  # 0 missed
    yield np.array([2, 0, 1, 1, 2, 0]), np.array([2, 1, 1, 0, 2, 2])


@pytest.mark.parametrize("labels,preds", list(_cases()))
def test_f1_macro_matches_sklearn(labels, preds):
    assert tmetrics.f1_macro(labels, preds) == pytest.approx(
        f1_score(labels, preds, average="macro"), abs=1e-12)


@pytest.mark.parametrize("probs,labels", [
    (np.random.default_rng(1).random(40),
     np.random.default_rng(2).integers(0, 2, 40)),
    (np.array([0.5, 0.5, 0.49, 0.51]), np.array([1, 0, 0, 1])),   # ties
    (np.array([0.9, 0.8, 0.7]), np.array([1, 1, 1])),             # one class
    (np.array([0.2, 0.3, 0.6]), np.array([1, 1, 1])),             # 0 missed
    (np.array([]), np.array([])),
])
def test_calc_qa_metrics_matches_reference(probs, labels):
    got = tqa.calc_qa_metrics(probs, labels, n_boot=50)
    want = jqa.calc_qa_metrics(probs, labels, n_boot=50)
    assert set(got) == set(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_bootstrap_ci_matches_reference():
    v = np.random.default_rng(3).random(30)
    v[4] = np.nan
    assert tmetrics.bootstrap_ci(v, n_boot=100) \
        == jmetrics.bootstrap_ci(v, n_boot=100)
    assert all(np.isnan(tmetrics.bootstrap_ci(np.array([np.nan]))))


class _Cache:
    def __init__(self):
        self.saved = {}

    def load(self, name, key):
        if (name, key) not in self.saved:
            raise ValueError("not cached")
        return self.saved[(name, key)]

    def save(self, name, key, arr):
        self.saved[(name, key)] = arr


class _Fixed:
    name = "fixed"

    def __init__(self):
        self.calls = 0

    def get_predictions(self, dataset):
        self.calls += 1
        return np.array([0.9, 0.2, 0.6, 0.4]), np.array([1, 0, 0, 0])


def test_run_qa_eval_matches_reference_and_uses_the_cache():
    cache, model = _Cache(), _Fixed()
    first = tqa.run_qa_eval(model, None, cache=cache, dataset_name="d")
    again = tqa.run_qa_eval(model, None, cache=cache, dataset_name="d")
    assert model.calls == 1 and first == again
    assert first == jqa.run_qa_eval(_Fixed(), None)


def _configs(quant_mode):
    jcfg = juni.UnifiedConfig(
        llama=jllama.tiny_config(vocab_size=VOCAB, attn_backend="ref",
                                 remat=False, max_seq_len=256,
                                 quant_mode=quant_mode),
        esm=None, protein_embed_dim=32, token_projector_layers=2,
        token_projector_hidden=24, retrieval_dim=16, dtype=jnp.float32)
    lfields = {f.name: getattr(jcfg.llama, f.name)
               for f in dataclasses.fields(jcfg.llama)}
    lfields.update(dtype=torch.float32, attn_backend=None)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields.update(llama=tllama.LlamaConfig(**lfields),
                  contrastive=tcon.InfoNCEConfig(), dtype=torch.float32)
    return jcfg, tuni.UnifiedConfig(**fields)


@pytest.mark.parametrize("quant_mode,atol", [("dequant", 1e-4),
                                             ("w8a8", 2e-3)])
def test_procyon_qa_eval_matches_reference(quant_mode, atol):
    jcfg, tcfg = _configs(quant_mode)
    params = dict(juni.init_params(jax.random.PRNGKey(4), jcfg))
    if quant_mode == "w8a8":
        params["llama"] = jllama.quantize_params(params["llama"], jcfg.llama)
    data = [(i % 32, (3 * i) % 32, i % 2) for i in range(7)]
    jmodel = jpm.ProcyonQAEval(
        params, jcfg, jload_tokenizer(vocab_size=VOCAB),
        jdatasets.SyntheticStore(n_proteins=32, embed_dim=32),
        jinstruct.TaskLibrary().get("peptide_all_qa"), batch_size=4)
    tmodel = tpm.ProcyonQAEval(
        bridge.to_torch(params), tcfg, tload_tokenizer(vocab_size=VOCAB),
        tdatasets.SyntheticStore(n_proteins=32, embed_dim=32),
        tinstruct.TaskLibrary().get("peptide_all_qa"), batch_size=4,
        device="cpu")
    want, wl = jmodel.get_predictions(data)
    got, gl = tmodel.get_predictions(data)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert tqa.run_qa_eval(tmodel, data)["n"] == len(data)
    with pytest.raises(ValueError, match="device"):
        tpm.ProcyonQAEval(bridge.to_torch(params), tcfg, None, None,
                          jinstruct.TaskLibrary().get("peptide_all_qa"))
