"""procyon_tpu_torch's BERTScore (evaluate/bertscore.py), its caption
metrics and its two CLIs against procyon_tpu's on the CPU.

Tolerances: `_pair_scores` and every scorer's precision / recall / F1
within 1e-5 of the JAX package's on the same inputs and the JAX
init_params carried across by the bridge (f32): one packed batch, idf on
and off, several references (best F1), chunks smaller than the pairs
(texts deduplicated within a chunk), baseline rescaling, compute_baseline,
make_scorer() (synthetic) and make_scorer(checkpoint_dir) on a local
checkpoint written here. calc_caption_metrics(use_bertscore=True) and
run_caption_eval equal the JAX package's within 1e-5 for the BERTScore
keys and exactly for the rest. `run_eval_framework --use_bertscore` and
`compute_bertscore_baseline` run on the CPU; the latter's record has the
JAX script's keys, and its constants are the library's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.data.wordpiece import WordPieceTokenizer as JTok
from procyon_tpu.evaluate import bertscore as jbs
from procyon_tpu.evaluate import caption as jcap
from procyon_tpu.models import bert as jbert
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data.wordpiece import WordPieceTokenizer as TTok
from procyon_tpu_torch.evaluate import bertscore as tbs
from procyon_tpu_torch.evaluate import caption as tcap
from procyon_tpu_torch.scripts import compute_bertscore_baseline as tbase_cli
from procyon_tpu_torch.scripts import run_eval_framework as tcli
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_text_common import hf_bert_state, port_bert_config

TOL = 1e-5
WORDS = ["protein", "binding", "membrane", "kinase", "phenotype", "signal",
         "transport", "enzyme", "pathway", "receptor", "domain", "complex",
         "nuclear", "growth", "response", "atp", "repair"]


def _sentences(n, seed, lo=2, hi=20):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def scorers():
    """(JAX scorer, port scorer) on the same 3-layer encoder, layer 2."""
    jcfg = jbert.tiny_config(n_layers=3)
    jparams = jbert.init_params(jax.random.PRNGKey(11), jcfg)
    kw = dict(layer=2, batch_size=64)
    j = jbs.BERTScorer(jparams, jcfg, JTok.synthetic(words=WORDS[:10]), **kw)
    t = tbs.BERTScorer(bridge.to_torch(jparams), port_bert_config(jcfg),
                       TTok.synthetic(words=WORDS[:10]), **kw)
    return j, t


def _close(got, want):
    for field in ("precision", "recall", "f1"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=field)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_scores_match_reference(seed):
    rng = np.random.default_rng(seed)
    N, S, d, P = 6, 11, 8, 9
    emb = rng.standard_normal((N, S, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    mask = (rng.random((N, S)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    w = rng.uniform(0.2, 2.0, (N, S)).astype(np.float32)
    c = rng.integers(0, N, P)
    r = rng.integers(0, N, P)
    want = jbs._pair_scores(*(jnp.asarray(x) for x in (emb, mask, w, c, r)))
    got = tbs._pair_scores(*(torch.from_numpy(x) for x in (emb, mask, w)),
                           torch.from_numpy(c), torch.from_numpy(r))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("refs_per", [1, 3])
@pytest.mark.parametrize("batch_size", [64, 5])
def test_scores_match_reference(scorers, idf, refs_per, batch_size):
    """Several references take the best F1; a batch_size below the pairs
    cuts them into chunks whose texts are deduplicated (a candidate is
    also one of its references in one pair)."""
    j, t = scorers
    cands = _sentences(12, 3)
    refs = [_sentences(refs_per, 10 + i) for i in range(12)]
    refs[4][0] = cands[4]
    refs = [r[0] if refs_per == 1 else r for r in refs]
    for s in (j, t):
        s.idf, s.batch_size = idf, batch_size
    _close(t.score(cands, refs), j.score(cands, refs))
    if refs_per == 1:
        assert t.score(cands, refs).f1[4] == pytest.approx(1.0, abs=1e-5)
    assert t.last_timing["pairs"] == 12 * refs_per
    assert t.last_timing["encoder_calls"] == -(-12 * refs_per // batch_size)


def test_baseline_rescaling_matches_reference(scorers):
    j, t = scorers
    cands, refs = _sentences(8, 5), _sentences(8, 6)
    for s in (j, t):
        s.idf, s.batch_size, s.baseline = False, 64, (0.61, 0.58, 0.6)
    try:
        got, want = t.score(cands, refs), j.score(cands, refs)
    finally:
        for s in (j, t):
            s.baseline = None
    _close(got, want)
    raw = t.score(cands, refs)
    np.testing.assert_allclose(got.f1, (raw.f1 - 0.6) / 0.4, atol=1e-6)


@pytest.mark.parametrize("idf", [False, True])
def test_compute_baseline_matches_reference(scorers, idf):
    j, t = scorers
    corpus = _sentences(30, 8)
    for s in (j, t):
        s.idf, s.batch_size = idf, 64
    got = tbs.compute_baseline(t, corpus, n_pairs=70, seed=3)
    want = jbs.compute_baseline(j, corpus, n_pairs=70, seed=3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert t.baseline is None


def test_compute_idf_matches_reference():
    refs = _sentences(20, 9)
    assert tbs.compute_idf(refs, TTok.synthetic(words=WORDS)) \
        == jbs.compute_idf(refs, JTok.synthetic(words=WORDS))


def test_make_scorer_synthetic_matches_reference():
    """make_scorer(): the 2-layer tiny encoder (f32 on the CPU), layer 2,
    the synthetic vocabulary; on the JAX synthetic scorer's weights the
    scores agree."""
    j = jbs.make_scorer()
    t = tbs.make_scorer(device="cpu")
    assert t.cfg == port_bert_config(j.cfg) and t.layer == j.layer == 2
    assert t.tokenizer.vocab == j.tokenizer.vocab
    assert t.params["embed"]["word"].dtype == torch.float32
    t.params = bridge.to_torch(j.params)
    cands, refs = _sentences(6, 1), _sentences(6, 2)
    _close(t.score(cands, refs), j.score(cands, refs))
    with pytest.raises(ValueError, match="out of range"):
        tbs.BERTScorer(t.params, t.cfg, t.tokenizer, layer=3)


def _checkpoint_dir(tmp_path):
    from safetensors.numpy import save_file
    save_file(hf_bert_state(dim=128, layers=3, prefix="bert.", seed=4),
              str(tmp_path / "model.safetensors"))
    vocab = TTok.synthetic(words=WORDS).vocab
    (tmp_path / "vocab.txt").write_text(
        "\n".join(sorted(vocab, key=vocab.get)) + "\n", encoding="utf-8")
    return str(tmp_path)


def test_make_scorer_from_a_checkpoint_matches_reference(tmp_path):
    path = _checkpoint_dir(tmp_path)
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"precision": 0.5, "recall": 0.4,
                                    "f1": 0.45}))
    kw = dict(layer=2, idf=True, baseline_file=str(baseline))
    j = jbs.make_scorer(path, dtype=jnp.float32, **kw)
    t = tbs.make_scorer(path, device="cpu", **kw)
    assert t.baseline == j.baseline == (0.5, 0.4, 0.45)
    assert t.cfg == port_bert_config(j.cfg) and t.cfg.n_layers == 3
    cands, refs = _sentences(10, 12), _sentences(10, 13)
    _close(t.score(cands, refs), j.score(cands, refs))
    assert tbs.load_baseline(str(baseline)) == (0.5, 0.4, 0.45)


def test_caption_metrics_with_bertscore_match_reference(scorers):
    j, t = scorers
    for s in (j, t):
        s.idf, s.batch_size = False, 4
    refs = {1: ["protein binding atp kinase", "an atp binding kinase"],
            2: ["membrane transport of ions"], 3: ["unused reference"]}
    preds = {1: "a kinase that binds atp", 2: "ion transport",
             4: "no reference for this one"}
    got = tcap.calc_caption_metrics(preds, refs, bertscorer=t, n_boot=40)
    want = jcap.calc_caption_metrics(preds, refs, bertscorer=j, n_boot=40)
    assert got.keys() == want.keys() and got["n"] == 2
    for k in want:
        tol = TOL if k.startswith("bertscore") else 0
        assert got[k] == pytest.approx(want[k], abs=tol), k

    class Fixed:
        name = "fixed"

        def get_predictions(self, dataset):
            return {a: preds[a] for a in dataset}

    got = tcap.run_caption_eval(Fixed(), [1, 2], references=refs,
                                use_bertscore=True, bertscorer=t)
    want = jcap.run_caption_eval(Fixed(), [1, 2], references=refs,
                                 use_bertscore=True, bertscorer=j)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=TOL), k
    empty = tcap.calc_caption_metrics({9: "x"}, refs, bertscorer=t)
    assert np.isnan(empty["bertscore_f1"])


def test_use_bertscore_alone_builds_the_synthetic_scorer(monkeypatch):
    """With use_bertscore and no scorer the caption metrics build
    make_scorer()'s (on the card by default; here on the CPU)."""
    made = []
    real = tbs.make_scorer

    def on_cpu(*a, **kw):
        made.append(kw)
        return real(*a, device="cpu", **kw)

    monkeypatch.setattr(tbs, "make_scorer", on_cpu)
    m = tcap.calc_caption_metrics({1: "protein binding"},
                                  {1: ["protein binding"]},
                                  use_bertscore=True)
    assert made == [{}]
    assert m["bertscore_f1"] == pytest.approx(1.0, abs=1e-5)


def test_run_eval_framework_with_bertscore(tmp_path):
    """`run_eval_framework --synthetic --use_bertscore --device cpu`: the
    ProCyon captions scored by BERTScore too, from a local checkpoint at
    layer 1 with a baseline file; every BERTScore key finite."""
    path = _checkpoint_dir(tmp_path)
    bl = tmp_path / "bl.json"
    tbase_cli.main(["--synthetic", "--model_dir", path, "--layer", "1",
                    "--n_pairs", "20", "--device", "cpu", "--out", str(bl)])
    out = tmp_path / "out"
    assert tcli.main(["--synthetic", "--device", "cpu", "--tasks", "caption",
                      "--models", "procyon", "--caption_max_len", "3",
                      "--use_bertscore", "--bertscore_model_dir", path,
                      "--bertscore_layer", "1",
                      "--bertscore_baseline_file", str(bl),
                      "--output_dir", str(out)]) == 0
    rows = [ln.rstrip("\n").split("\t") for ln in
            open(out / "caption_metrics.tsv")][1:]
    got = {r[2]: float(r[3]) for r in rows}
    for k in ("bertscore_f1", "bertscore_precision", "bertscore_recall"):
        assert np.isfinite(got[k]), k
    assert got["n"] == 4


def test_compute_bertscore_baseline_cli(tmp_path):
    """The port's CLI on a local checkpoint and a sentence file: its
    constants are compute_baseline's on make_scorer's scorer, and the
    record has the JAX script's keys and metadata."""
    path = _checkpoint_dir(tmp_path)
    sents = tmp_path / "s.txt"
    sents.write_text("\n".join(_sentences(12, 14)) + "\n")
    argv = ["--sentences", str(sents), "--model_dir", path, "--layer", "2",
            "--idf", "--n_pairs", "30", "--seed", "5"]
    rec = tbase_cli.main(argv + ["--device", "cpu", "--out",
                                 str(tmp_path / "t.json")])
    scorer = tbs.make_scorer(path, layer=2, idf=True, device="cpu")
    want = tbs.compute_baseline(scorer, _sentences(12, 14), n_pairs=30,
                                seed=5)
    assert (rec["precision"], rec["recall"], rec["f1"]) == want
    assert json.load(open(tmp_path / "t.json")) == rec
    from torch_text_common import jax_script
    import sys
    jout = tmp_path / "j.json"
    old = sys.argv
    sys.argv = ["compute_bertscore_baseline.py", *argv, "--out", str(jout)]
    try:
        jax_script("compute_bertscore_baseline").main()
    finally:
        sys.argv = old
    jrec = json.load(open(jout))
    assert jrec.keys() == rec.keys()
    for k in ("layer", "idf", "n_pairs", "n_sentences", "seed", "model_dir",
              "method"):
        assert jrec[k] == rec[k], k
    # the JAX script runs its encoder in bf16, the port's CLI in f32 here
    np.testing.assert_allclose([rec["f1"]], [jrec["f1"]], atol=2e-2)
