"""procyon_tpu_torch's LLM-as-a-judge pipeline (evaluate/llm_judge.py and
scripts/llm_judge_pipeline.py) against procyon_tpu's on the CPU: judge
prompts (A/B order by seed), verdict parsing, the order-aware tally with
its bootstrap CI, stratified sampling and the reference-based metrics
equal to the JAX package's; the CLI's four subcommands write and print
what the JAX script does (refscore's BERTScore keys within 1e-5, on one
local checkpoint read by both)."""

import csv
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from procyon_tpu.evaluate import bertscore as jbs
from procyon_tpu.evaluate import llm_judge as jlj
from procyon_tpu_torch.evaluate import bertscore as tbs
from procyon_tpu_torch.evaluate import llm_judge as tlj
from procyon_tpu_torch.scripts import llm_judge_pipeline as tcli
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_text_common import hf_bert_state, jax_script


def _entries(n=9):
    rng = np.random.default_rng(0)
    words = ["kinase", "membrane", "binding", "transport", "repair", "dna"]
    return [{"entity_id": f"P{i}", "question": "Describe it.",
             "references": [" ".join(rng.choice(words, 4))
                            for _ in range(1 + i % 3)]
             if i % 4 else "one reference string",
             "ours": " ".join(rng.choice(words, 5)),
             "baseline": " ".join(rng.choice(words, 3))} for i in range(n)]


@pytest.mark.parametrize("seed", [0, 3])
def test_judge_prompts_match_reference(seed):
    got = tlj.make_judge_prompts(_entries(), seed=seed, max_refs=2)
    want = jlj.make_judge_prompts(_entries(), seed=seed, max_refs=2)
    assert [(p.entity_id, p.prompt, p.ours_is_a) for p in got] \
        == [(p.entity_id, p.prompt, p.ours_is_a) for p in want]
    assert {p.ours_is_a for p in got} == {True, False}
    assert tlj.JUDGE_TEMPLATE == jlj.JUDGE_TEMPLATE


@pytest.mark.parametrize("text", [
    "[[A]]", "blah [[B]] then [[C]]", "restating [[A]]/[[B]]; final [[B]]",
    "no verdict", "", None, "[[D]] [A]"])
def test_verdict_parsing_matches_reference(text):
    assert tlj.parse_judge_verdict(text) == jlj.parse_judge_verdict(text)


def test_tally_matches_reference():
    prompts = tlj.make_judge_prompts(_entries(20), seed=1)
    jprompts = jlj.make_judge_prompts(_entries(20), seed=1)
    rng = np.random.default_rng(2)
    responses = [rng.choice(["ok [[A]]", "[[B]]", "tie [[C]]", "???"])
                 for _ in prompts]
    got = tlj.tally_judge_results(prompts, responses, n_boot=300, seed=4)
    want = jlj.tally_judge_results(jprompts, responses, n_boot=300, seed=4)
    assert got == want and got["n_unparsed"] > 0
    assert tlj.tally_judge_results([], [], seed=0) \
        == jlj.tally_judge_results([], [], seed=0)


@pytest.mark.parametrize("n_per,n_strata", [(2, 5), (10, 3), (1, 1)])
def test_stratified_sample_matches_reference(n_per, n_strata):
    rng = np.random.default_rng(5)
    ids = [f"E{i}" for i in range(40)]
    scores = rng.integers(1, 6, 40).astype(float)
    assert tlj.stratified_sample(ids, scores, n_per, n_strata=n_strata,
                                 seed=7) \
        == jlj.stratified_sample(ids, scores, n_per, n_strata=n_strata,
                                 seed=7)


def test_reference_metrics_match_reference():
    e = _entries()
    ours = {x["entity_id"]: x["ours"] for x in e}
    base = {x["entity_id"]: x["baseline"] for x in e[1:]}
    refs = {x["entity_id"]: (x["references"] if isinstance(
        x["references"], list) else [x["references"]]) for x in e}
    assert tlj.reference_metrics(ours, base, refs) \
        == jlj.reference_metrics(ours, base, refs)


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return str(path)


@pytest.fixture
def files(tmp_path):
    e = _entries()
    return {
        "ours": _write(tmp_path / "ours.csv", ["entity_id", "caption"],
                       [(x["entity_id"], x["ours"]) for x in e]),
        "baseline": _write(tmp_path / "base.csv", ["entity_id", "caption"],
                           [(x["entity_id"], x["baseline"]) for x in e]),
        "references": _write(
            tmp_path / "refs.csv", ["entity_id", "reference"],
            [(x["entity_id"], r) for x in e for r in (
                x["references"] if isinstance(x["references"], list)
                else [x["references"]])]),
        "scores": _write(tmp_path / "scores.csv", ["entity_id", "score"],
                         [(f"P{i}", 1 + i % 5) for i in range(30)]),
        "dir": tmp_path,
    }


def _jax_cli(argv, capsys):
    old = sys.argv
    sys.argv = ["llm_judge_pipeline.py", *argv]
    try:
        capsys.readouterr()
        jax_script("llm_judge_pipeline").main()
    finally:
        sys.argv = old
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_select_prompts_tally_match_the_reference_script(files, capsys):
    d = files["dir"]
    for name, run in (("t", lambda a: tcli.main(a)),
                      ("j", lambda a: _jax_cli(a, capsys))):
        run(["select", "--scores", files["scores"], "--n_per_stratum", "3",
             "--seed", "2", "--out", str(d / f"{name}_sel.csv")])
        run(["prompts", "--ours", files["ours"], "--baseline",
             files["baseline"], "--references", files["references"],
             "--seed", "1", "--out", str(d / f"{name}_prompts.csv")])
    for f in ("sel.csv", "prompts.csv"):
        assert (d / f"t_{f}").read_text() == (d / f"j_{f}").read_text(), f
    rows = list(csv.DictReader(open(d / "t_prompts.csv")))
    responses = _write(d / "resp.csv", ["entity_id", "response"],
                       [(r["entity_id"], ["[[A]]", "[[B]]", "[[C]]"][i % 3])
                        for i, r in enumerate(rows)])
    argv = ["tally", "--prompts", str(d / "t_prompts.csv"), "--responses",
            responses, "--seed", "3"]
    got = tcli.main(argv)
    assert got == _jax_cli(argv, capsys)
    assert got["n"] == len(rows)


def test_cli_refscore_matches_the_reference_script(files, capsys):
    """refscore with BERTScore from one local checkpoint (the JAX script
    loads it in bf16, so its BERTScore is held to the port's within 2e-2;
    the port's own scorer in f32 within 1e-5 of JAX's f32 one)."""
    from safetensors.numpy import save_file
    from procyon_tpu_torch.data.wordpiece import WordPieceTokenizer

    d = files["dir"] / "ckpt"
    d.mkdir()
    save_file(hf_bert_state(dim=128, layers=9, prefix="bert.", seed=6),
              str(d / "model.safetensors"))
    vocab = WordPieceTokenizer.synthetic(
        words=["kinase", "membrane", "binding"]).vocab
    (d / "vocab.txt").write_text("\n".join(sorted(vocab, key=vocab.get))
                                 + "\n")
    argv = ["refscore", "--ours", files["ours"], "--baseline",
            files["baseline"], "--references", files["references"],
            "--use_bertscore", "--bertscore_model_dir", str(d)]
    got = tcli.main(argv + ["--device", "cpu"])
    want = _jax_cli(argv, capsys)
    plain = tcli.main(argv[:7])
    assert plain == _jax_cli(argv[:7], capsys)
    for side in ("ours", "baseline"):
        assert got[side].keys() == want[side].keys()
        for k, v in want[side].items():
            tol = 2e-2 if k.startswith("bertscore") else 0
            assert got[side][k] == pytest.approx(v, abs=tol), (side, k)
    # the same checkpoint in f32 on both sides: within 1e-5
    j = jbs.make_scorer(str(d), dtype=jnp.float32)
    t = tbs.make_scorer(str(d), device="cpu")
    e = _entries()
    refs = [x["references"] for x in e]
    a = t.score([x["ours"] for x in e], refs)
    b = j.score([x["ours"] for x in e], refs)
    np.testing.assert_allclose(a.f1, np.asarray(b.f1), atol=1e-5, rtol=0)
