"""procyon_tpu_torch's third-party baselines (evaluate/baselines/
text_models.py, protllm.py and their zoo entries in evaluate/core.py)
against procyon_tpu's on the CPU.

Every comparison runs both packages on the same seeded inputs, the port
on the JAX package's random weights carried across by the bridge (f32):
- one_hot_protein equal; cnn_forward (the DeepGOPlus tower: 16 valid
  conv1d, global max, Linear + LeakyReLU) within 1e-4; the three
  projection kinds within 1e-5; BertTextTower under each pooler within
  1e-4;
- each of the five zoo entries (biotranslator, protst, pubmedbert, simcse,
  protllm) through run_evaluation with its towers preloaded in the
  context: the cached scores within 1e-4 of the JAX package's and every
  metric within 1e-4; with nothing preloaded each builds seeded synthetic
  towers on the context's device;
- the released-checkpoint converters against the torch modules of
  tests/test_baseline_converters.py (the BioDataEncoder CNN within 1e-5, a
  transposed weight shown to differ; the TextEncoder's BERT and bias-free
  GELU head within 2e-4), and load_torch_state's unwrapping.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.evaluate import core as jcore
from procyon_tpu.evaluate.baselines import protllm as jpl
from procyon_tpu.evaluate.baselines import text_models as jtm
from procyon_tpu.models import bert as jbert
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data.text_tokenizer import WordTokenizer
from procyon_tpu_torch.data.wordpiece import WordPieceTokenizer as TTok
from procyon_tpu_torch.evaluate import core as tcore
from procyon_tpu_torch.evaluate.baselines import protllm as tpl
from procyon_tpu_torch.evaluate.baselines import text_models as ttm
from procyon_tpu_torch.models import esm2 as tesm
from procyon_tpu_torch.models import llama as tllama
from test_baseline_converters import _tiny_hf_bert, _TorchBioDataEncoder
from test_baseline_models import FakeStore
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_text_common import port_bert_config, proj_to_torch

ATOL = 1e-4
CNN = dict(out_channels=8, max_kernel=25, seq_length=64, hidden_dim=16)


def _port_cfg(jcfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in names and f.name not in ("dtype", "lora")}
    return cls(**kw, dtype=torch.float32)


def _tower(jt: jtm.BertTextTower) -> ttm.BertTextTower:
    """A JAX text tower's weights and settings in the port's tower."""
    return ttm.BertTextTower(
        bridge.to_torch(jt.params), port_bert_config(jt.cfg),
        TTok(dict(jt.tokenizer.vocab)), pooler=jt.pooler,
        proj=proj_to_torch(jt.proj), max_len=jt.max_len,
        batch_size=jt.batch_size,
        exclude_special_from_mean=jt.exclude_special)


@pytest.mark.parametrize("seq,max_len", [("AR", 4), ("ARNDX", 10),
                                         ("ACDEFGHIKLMNPQRSTVWYBZ", 16),
                                         ("MKV" * 30, 50)])
def test_one_hot_matches_reference(seq, max_len):
    got = ttm.one_hot_protein(seq, max_len)
    np.testing.assert_array_equal(got, jtm.one_hot_protein(seq, max_len))
    np.testing.assert_array_equal(got.sum(1), 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_cnn_forward_matches_reference(seed):
    cfg = jtm.CNNConfig(**CNN)
    jp = jtm.init_cnn_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, cfg.seq_length, 21)).astype(np.float32)
    want = np.asarray(jtm.cnn_forward(jp, cfg, jnp.asarray(x)))
    got = ttm.cnn_forward(bridge.to_torch(jp), ttm.CNNConfig(**CNN),
                          torch.from_numpy(x))
    assert got.shape == (3, cfg.hidden_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_init_cnn_params_is_the_reference_tree():
    cfg = ttm.CNNConfig(**CNN)
    a = ttm.init_cnn_params(3, cfg, device="cpu")
    b = ttm.init_cnn_params(3, cfg, device="cpu")
    want = jtm.init_cnn_params(jax.random.PRNGKey(0), jtm.CNNConfig(**CNN))
    assert len(a["convs"]) == len(want["convs"]) == len(cfg.kernels) == 3
    for x, y, w in zip(a["convs"], b["convs"], want["convs"]):
        assert tuple(x["w"].shape) == w["w"].shape and torch.equal(x["w"],
                                                                   y["w"])
    assert tuple(a["fc_w"].shape) == want["fc_w"].shape


@pytest.mark.parametrize("kind", ["mlp", "tower_mlp", "linear"])
def test_projections_match_reference(kind):
    jp = jtm.init_mlp_proj(jax.random.PRNGKey(1), 24, 8, kind=kind)
    x = np.random.default_rng(1).standard_normal((5, 24)).astype(np.float32)
    want = np.asarray(jtm.apply_proj(jp, jnp.asarray(x)))
    tp = proj_to_torch(jp)
    assert tp.act == jp.act and [b is None for b in tp.bs] \
        == [b is None for b in jp.bs]
    np.testing.assert_allclose(ttm.apply_proj(tp, torch.from_numpy(x))
                               .numpy(), want, atol=1e-5, rtol=0)
    own = ttm.init_mlp_proj(1, 24, 8, kind=kind, device="cpu")
    assert [tuple(w.shape) for w in own.ws] == [w.shape for w in jp.ws]
    assert own.act == jp.act
    assert ttm.apply_proj(None, torch.ones(2)).tolist() == [1.0, 1.0]


@pytest.mark.parametrize("pooler,exclude,proj", [
    ("cls", False, "mlp"), ("mean", True, "tower_mlp"), ("max", False, None),
    ("cls_before_pooler", False, "linear")])
def test_text_tower_matches_reference(pooler, exclude, proj):
    from procyon_tpu.data.wordpiece import WordPieceTokenizer as JTok

    cfg = jbert.tiny_config()
    jp = jbert.init_params(jax.random.PRNGKey(2), cfg)
    jproj = None if proj is None else jtm.init_mlp_proj(
        jax.random.PRNGKey(3), cfg.dim, 12, kind=proj)
    jt = jtm.BertTextTower(jp, cfg, JTok.synthetic(), pooler=pooler,
                           proj=jproj, batch_size=3,
                           exclude_special_from_mean=exclude)
    texts = [FakeStore().text(i) for i in range(5)] + ["a", "kinase atp"]
    want = jt.embed_texts(texts)
    got = _tower(jt).embed_texts(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _contexts():
    """The JAX context's towers (from the JAX synthetic constructors) and
    the port's, carried across."""
    store = FakeStore(n_proteins=6, n_texts=4)
    jb = jtm.BioTranslatorRetrievalEval.synthetic(store, seed=1)
    jp = jtm.ProtSTRetrievalEval.synthetic(store, seed=2)
    # mean pooling: the tiny random encoder's [CLS] rows are so alike that
    # their cosines tie to 1e-7, and a ranking metric then turns on f32
    # noise in either package
    jte = jtm.TextEncoderRetrievalEval.synthetic(store, None, seed=3,
                                                 pooler="mean")
    jsc = jtm.TextEncoderRetrievalEval.synthetic(store, None, seed=4,
                                                 pooler="mean")
    jl = jpl.ProtLLMQAEval.synthetic(store, seed=5)
    jctx = {
        "biotranslator": {"text_tower": jb.text_tower,
                          "cnn_params": jb.cnn_params,
                          "cnn_cfg": jb.cnn_cfg},
        "protst": {"text_tower": jp.text_tower, "esm_params": jp.esm_params,
                   "esm_cfg": jp.esm_cfg, "graph_proj": jp.graph_proj},
        "pubmedbert": {"tower": jte.tower}, "simcse": {"tower": jsc.tower},
        "protllm": {"esm_params": jl.esm_params, "esm_cfg": jl.esm_cfg,
                    "llama_params": jl.llama_params,
                    "llama_cfg": jl.llama_cfg, "projector": jl.projector,
                    "tokenizer": jl.tokenizer},
    }
    tctx = {
        "biotranslator": {"text_tower": _tower(jb.text_tower),
                          "cnn_params": bridge.to_torch(jb.cnn_params),
                          "cnn_cfg": ttm.CNNConfig(
                              **dataclasses.asdict(jb.cnn_cfg))},
        "protst": {"text_tower": _tower(jp.text_tower),
                   "esm_params": bridge.to_torch(jp.esm_params),
                   "esm_cfg": _port_cfg(jp.esm_cfg, tesm.ESM2Config),
                   "graph_proj": proj_to_torch(jp.graph_proj)},
        "pubmedbert": {"tower": _tower(jte.tower)},
        "simcse": {"tower": _tower(jsc.tower)},
        "protllm": {"esm_params": bridge.to_torch(jl.esm_params),
                    "esm_cfg": _port_cfg(jl.esm_cfg, tesm.ESM2Config),
                    "llama_params": bridge.to_torch(jl.llama_params),
                    "llama_cfg": _port_cfg(jl.llama_cfg, tllama.LlamaConfig),
                    "projector": bridge.to_torch(jl.projector),
                    "tokenizer": WordTokenizer(
                        vocab_size=jl.llama_cfg.vocab_size)},
    }
    return store, jctx, tctx


def _datasets(store):
    rels = [(a, a % 4) for a in range(6)]
    return {
        "synth_retrieval": {"task": "retrieval", "eval_relations": rels,
                            "query_order": [0, 1, 2, 3],
                            "all_protein_ids": list(range(6)),
                            "store": store},
        "synth_qa": {"task": "qa", "store": store,
                     "qa_samples": [(a, a % 4, a % 2 == 0)
                                    for a in range(6)]},
    }


ZOO = [("retrieval", "biotranslator"), ("retrieval", "protst"),
       ("retrieval", "pubmedbert"), ("retrieval", "simcse"),
       ("qa", "protllm")]


@pytest.fixture(scope="module")
def zoo_runs(tmp_path_factory):
    """Each zoo entry through run_evaluation in both packages, a run (and
    a prediction cache) of its own: the JAX zoo caches both text encoders
    under the class's name, "text_encoder", so in one run simcse would read
    back pubmedbert's scores (the port names them by their zoo names)."""
    root = tmp_path_factory.mktemp("zoo")
    store, jctx, tctx = _contexts()
    out = {}
    for name, core, ctx in (("jax", jcore, jctx), ("port", tcore, tctx)):
        ctx["protein_text_fn"] = lambda a: " ".join(
            store.protein_sequence(a))
        for task, model in ZOO:
            run = root / name / model
            args = core.EvalArgs(
                tasks=(task,), models=(model,),
                output_dir=str(run / "out"), cache_dir=str(run / "cache"),
                retrieval=core.ret.RetrievalEvalConfig(n_boot=20))
            (r,) = core.run_evaluation(args, _datasets(store),
                                       model_context=ctx)
            (path,) = (run / "cache").iterdir()
            with open(path, "rb") as f:
                scores = pickle.load(f)["predictions"]
            out[name, model] = (r["metrics"], scores, path.name)
    return out


@pytest.mark.parametrize("task,model", ZOO)
def test_zoo_entry_matches_reference(zoo_runs, task, model):
    (got, a, fname), (want, b, _) = zoo_runs["port", model], \
        zoo_runs["jax", model]
    assert fname.startswith(f"{model}__")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ATOL, nan_ok=True), k
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_zoo_entries_build_synthetic_towers_on_the_context_device(
        tmp_path):
    """Nothing preloaded: each entry builds seeded synthetic towers on
    ctx["device"] and runs; the retrieval scores are cosines."""
    store = FakeStore(n_proteins=6, n_texts=4)
    args = tcore.EvalArgs(tasks=("retrieval", "qa"),
                          models=tuple(m for _, m in ZOO),
                          output_dir=str(tmp_path / "out"),
                          cache_dir=str(tmp_path / "cache"))
    results = tcore.run_evaluation(args, _datasets(store),
                                   model_context={"device": "cpu"})
    assert {(r["task"], r["model"]) for r in results} == set(ZOO)
    for r in results:
        if r["task"] == "retrieval":
            assert 0.0 <= r["metrics"]["auprc"] <= 1.0
    for task, model in ZOO[:4]:
        with open(tmp_path / "cache"
                  / f"{model}__synth_retrieval__predictions.pkl", "rb") as f:
            s = pickle.load(f)["predictions"]
        assert np.isfinite(s).all() and np.abs(s).max() <= 1 + 1e-5


def test_protllm_reads_the_spliced_protein():
    """The projected protein embedding reaches the decoder: another protein
    with the same text moves the yes-probability."""
    store = FakeStore()
    m = tpl.ProtLLMQAEval.synthetic(store, device="cpu")
    (p1,), labels = m.get_predictions([(0, 0, True)])
    (p2,), _ = m.get_predictions([(7, 0, True)])
    assert 0.0 <= p1 <= 1.0 and list(labels) == [True]
    assert abs(p1 - p2) > 1e-6


def test_cnn_converter_matches_the_torch_module(tmp_path):
    cfg = ttm.CNNConfig(out_channels=21, max_kernel=17, seq_length=64,
                        hidden_dim=16)
    torch.manual_seed(0)
    ref = _TorchBioDataEncoder(cfg).eval()
    path = str(tmp_path / "data_encoder.pth")
    torch.save(ref.state_dict(), path)
    state = ttm.load_torch_state(path)
    params = ttm.convert_biotranslator_cnn(state, cfg, device="cpu")
    jparams = jtm.convert_biotranslator_cnn(
        {k: v.numpy() for k, v in state.items()}, jtm.CNNConfig(
            **dataclasses.asdict(cfg)))
    x = np.random.default_rng(0).standard_normal(
        (3, cfg.seq_length, 21)).astype(np.float32)
    got = ttm.cnn_forward(params, cfg, torch.from_numpy(x))
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 2, 1)))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jtm.cnn_forward(
            jparams, jtm.CNNConfig(**dataclasses.asdict(cfg)),
            jnp.asarray(x))), atol=1e-5, rtol=0)
    # the torch [out, in, k] weight taken without the transpose's axes
    # (square in / out channels, so it runs) gives other features
    bad = dict(params, convs=[
        {"w": state[f"conv1d_{i}.weight"].permute(2, 0, 1).contiguous(),
         "b": c["b"]} for i, c in enumerate(params["convs"])])
    assert not torch.allclose(ttm.cnn_forward(bad, cfg, torch.from_numpy(x)),
                              got)


def test_text_converter_matches_the_torch_modules(tmp_path):
    """The released TextEncoder layout: text.transformer.* BERT weights and
    the text.proj.{0,2} bias-free Linear-GELU-Linear head; the port's BERT
    (cls) through the converted head against transformers' BertModel and
    the torch head within 2e-4 (the port's GELU is the tanh form, as the
    JAX package's)."""
    model = _tiny_hf_bert()
    torch.manual_seed(2)
    proj = torch.nn.Sequential(torch.nn.Linear(64, 48, bias=False),
                               torch.nn.GELU(),
                               torch.nn.Linear(48, 32, bias=False)).eval()
    state = {f"text.transformer.{k}": v
             for k, v in model.state_dict().items()}
    state.update({f"text.proj.{i}.weight": m.weight
                  for i, m in enumerate(proj) if hasattr(m, "weight")})
    path = str(tmp_path / "text_encoder.pth")
    torch.save(state, path)
    params, cfg, head = ttm.convert_biotranslator_text(
        ttm.load_torch_state(path), dtype=torch.float32, device="cpu")
    assert head is not None and len(head.ws) == 2 and head.act == "gelu"
    assert head.bs == [None, None]
    from procyon_tpu_torch.models import bert as tbert
    cfg = dataclasses.replace(cfg, n_heads=4)
    ids = np.random.default_rng(0).integers(5, 128, (3, 16))
    out = tbert.forward(params, cfg, torch.from_numpy(ids))
    got = ttm.apply_proj(head, out["hidden"][:, 0])
    with torch.no_grad():
        want = proj(model(input_ids=torch.from_numpy(ids))
                    .last_hidden_state[:, 0])
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_load_torch_state_unwraps_and_drops_non_tensors(tmp_path):
    path = str(tmp_path / "nested.pth")
    w = torch.ones(2, 3, requires_grad=True)
    torch.save({"model": {"a.weight": w, "step": 7}}, path)
    state = ttm.load_torch_state(path)
    assert set(state) == {"a.weight"}
    assert state["a.weight"].dtype == torch.float32
    assert not state["a.weight"].requires_grad
    assert torch.equal(state["a.weight"], torch.ones(2, 3))


def test_run_eval_framework_runs_the_five_baselines(tmp_path):
    """`run_eval_framework --synthetic --device cpu` with the five
    third-party baselines: each writes its rows, every value finite. (The
    JAX script stops here: its text towers take the synthetic queries'
    73 WordPiece tokens against the tiny encoder's 64 positions; the
    port's towers truncate to the position table.)"""
    from procyon_tpu_torch.scripts import run_eval_framework as tcli

    out = tmp_path / "out"
    assert tcli.main(["--synthetic", "--device", "cpu", "--tasks",
                      "retrieval", "qa", "--models", *(m for _, m in ZOO),
                      "--output_dir", str(out)]) == 0
    for task in ("retrieval", "qa"):
        rows = [ln.rstrip("\n").split("\t")
                for ln in open(out / f"{task}_metrics.tsv")][1:]
        models = {r[0] for r in rows}
        assert models == {m for t, m in ZOO if t == task}
        assert all(np.isfinite(float(r[3])) for r in rows)
