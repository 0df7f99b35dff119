"""procyon_tpu_torch's evaluation framework (evaluate/core.py,
data_loading.py, caption.py and scripts/run_eval_framework.py) against
procyon_tpu's on the CPU.

- core.run_evaluation on the synthetic datasets of the JAX
  scripts/run_eval_framework.py (three blobs of 30 proteins) for procyon,
  knn, mlp, random and blast over retrieval and QA: the baselines' metrics
  equal to the JAX package's (within 1e-12); ProCyon's, computed from the
  JAX init_params carried across by the bridge, from scores within 1e-4 of
  the JAX package's (read back from both prediction caches), and metrics
  within 1e-4;
- the caption metrics equal the JAX package's, and the ProCyon caption
  path runs through run_evaluation;
- the zoo names of Slice 6b (BERT, BERTScore and the text baselines) and
  BERTScore raise NotImplementedError naming the item;
- `run_eval_framework --synthetic --device cpu` writes the JAX script's
  baseline rows to retrieval_metrics.tsv;
- qa_filter_captions.score_captions on the JAX init_params carried across
  by the bridge: each caption's yes-probability within 1e-4 of the JAX
  script's (`unified.forward`'s logits at [ANSWER] through `qa_yes_prob`,
  the caption as the text), and a replaced caption moves its own
  probability alone; `qa_filter_captions --synthetic --device cpu` keeps
  the captions whose yes-probability reaches the threshold.
"""

import os
import pickle

import numpy as np
import pytest

from procyon_tpu.data import datasets as jD
from procyon_tpu.evaluate import caption as jcap
from procyon_tpu.evaluate import core as jcore
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data import datasets as tD
from procyon_tpu_torch.data import instruct as tinstruct
from procyon_tpu_torch.data.text_tokenizer import load_tokenizer as \
    tload_tokenizer
from procyon_tpu_torch.evaluate import caption as tcap
from procyon_tpu_torch.evaluate import core as tcore
from procyon_tpu_torch.inference.generation import GenerationConfig
from procyon_tpu_torch.scripts import run_eval_framework as tcli
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_eval_common import (TABLE_DIM, VOCAB, jax_eval_script,
                               port_config, tiny_configs)

MODELS = ("procyon", "knn", "mlp", "random", "blast")
PAIRS = [("retrieval", m) for m in MODELS] + [("qa", m) for m in
                                              ("procyon", "knn", "random")]


def _blast(ctx):
    """A BLAST-like score matrix over the blob proteins, under the zoo's
    keys ("query_ids" is the protein index, "target_ids" the train
    relations, as the JAX zoo hands them to ScoreMatrixRetrievalModel)."""
    emb = ctx["protein_embeddings"]
    ids = sorted(emb)
    m = np.stack([emb[i] for i in ids])
    return {"matrix": m @ m.T, "query_ids": {a: r for r, a in enumerate(ids)},
            "target_ids": ctx["train_relations"]}


def _port_side(jctx):
    """The port's synthetic datasets and context, with the JAX model's
    weights carried across."""
    datasets, ctx = tcli.synthetic_datasets(False, "cpu")
    p = jctx["procyon"]
    store = tD.SyntheticStore(n_proteins=90, n_texts=1024, embed_dim=32)
    store._embeds = np.asarray(p["store"]._embeds)
    lib = tinstruct.TaskLibrary()
    for name in datasets:
        datasets[name]["task_json"] = lib.get(
            f"disgenet_all_{datasets[name]['task']}")
    ctx["procyon"] = {"params": bridge.to_torch(p["params"]),
                      "cfg": port_config(p["cfg"]),
                      "tokenizer": tload_tokenizer(vocab_size=4096),
                      "store": store, "device": "cpu"}
    return datasets, ctx


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """run_evaluation in both packages over retrieval and QA, predictions
    cached under each package's cache_dir."""
    root = tmp_path_factory.mktemp("runs")
    jdatasets, jctx = jax_eval_script().synthetic_datasets(True)
    tdatasets, tctx = _port_side(jctx)
    for ctx in (jctx, tctx):
        ctx["blast_scores"] = _blast(ctx)
    out = {}
    for name, core, datasets, ctx in (("jax", jcore, jdatasets, jctx),
                                      ("port", tcore, tdatasets, tctx)):
        args = core.EvalArgs(
            tasks=("retrieval", "qa"), models=MODELS,
            output_dir=str(root / name / "out"),
            cache_dir=str(root / name / "cache"),
            retrieval=core.ret.RetrievalEvalConfig(n_boot=50))
        results = core.run_evaluation(args, datasets, model_context=ctx)
        out[name] = {(r["task"], r["model"]): r["metrics"] for r in results}
        out[name + "_dir"] = root / name
    return out


def _cached(run_dir, model, dataset):
    with open(os.path.join(run_dir, "cache",
                           f"{model}__{dataset}__predictions.pkl"),
              "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("task,model", PAIRS)
def test_run_evaluation_matches_reference(both_runs, task, model):
    got, want = both_runs["port"][(task, model)], \
        both_runs["jax"][(task, model)]
    assert got.keys() == want.keys()
    tol = 1e-4 if model == "procyon" else 1e-12
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=tol, nan_ok=True), k
    if model == "procyon":
        key = "synthetic_retrieval" if task == "retrieval" \
            else "synthetic_qa__qa"
        a = _cached(both_runs["port_dir"], model, key)
        b = _cached(both_runs["jax_dir"], model, key)
        np.testing.assert_allclose(a["predictions"], b["predictions"],
                                   atol=1e-4, rtol=0)


def test_run_evaluation_writes_the_reference_rows(both_runs):
    """The TSVs hold the same (model, dataset, metric) rows in the same
    order, and the baselines' values as the JAX package writes them."""
    for task in ("retrieval", "qa"):
        rows = {}
        for name in ("port", "jax"):
            with open(both_runs[name + "_dir"] / "out"
                      / f"{task}_metrics.tsv") as f:
                rows[name] = [line.rstrip("\n").split("\t") for line in f]
        assert rows["port"][0] == ["model", "dataset", "metric", "value"]
        assert [r[:3] for r in rows["port"]] == [r[:3] for r in rows["jax"]]
        assert [r for r in rows["port"] if r[0] != "procyon"] \
            == [r for r in rows["jax"] if r[0] != "procyon"]


def test_caption_metrics_match_reference():
    rel = [(1, "the protein binds atp"), (1, "an atp binding kinase"),
           (2, "membrane transport of ions"), (3, "unused reference")]
    assert tcap.merge_references(rel) == jcap.merge_references(rel)
    refs = tcap.merge_references(rel)
    preds = {1: "a kinase that binds atp", 2: "ion transport",
             4: "no reference for this one"}
    got = tcap.calc_caption_metrics(preds, refs, n_boot=40)
    want = jcap.calc_caption_metrics(preds, refs, n_boot=40)
    assert got == want and got["n"] == 2

    class Fixed:
        name = "fixed"

        def get_predictions(self, dataset):
            return {a: preds[a] for a in dataset}

    assert tcap.run_caption_eval(Fixed(), [1, 2], references=refs) \
        == jcap.run_caption_eval(Fixed(), [1, 2], references=refs)
    assert np.isnan(tcap.calc_caption_metrics({}, refs)["rouge_l"])


def test_procyon_caption_runs_through_run_evaluation(tmp_path):
    datasets, ctx = tcli.synthetic_datasets(True, "cpu")
    tok = ctx["procyon"]["tokenizer"]
    ctx["procyon"]["generation_config"] = GenerationConfig(
        max_new_tokens=4, method="beam", beam_size=4, beam_group_size=2,
        diversity_penalty=0.8, eos_token_id=tok.spec.eos_id,
        pad_token_id=tok.spec.pad_id)
    args = tcore.EvalArgs(tasks=("caption",), models=("procyon", "knn"),
                          output_dir=str(tmp_path))
    (result,) = tcore.run_evaluation(args, datasets, model_context=ctx)
    m = result["metrics"]
    assert (result["task"], result["model"]) == ("caption", "procyon")
    assert m["n"] == 4 and 0.0 <= m["rouge_l"] <= 1.0 \
        and 0.0 <= m["bleu"] <= 1.0


@pytest.mark.parametrize("task,name", [
    ("retrieval", "biotranslator"), ("retrieval", "protst"),
    ("retrieval", "pubmedbert"), ("retrieval", "simcse"), ("qa", "protllm")])
def test_slice_6b_models_raise_naming_the_item(tmp_path, task, name):
    datasets, ctx = tcli.synthetic_datasets(False)
    args = tcore.EvalArgs(tasks=(task,), models=(name,),
                          output_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="Slice 6b"):
        tcore.run_evaluation(args, datasets, model_context=ctx)


def test_bertscore_raises_naming_the_item(tmp_path):
    with pytest.raises(NotImplementedError, match="Slice 6b"):
        tcap.calc_caption_metrics({1: "a"}, {1: ["a"]}, use_bertscore=True)
    with pytest.raises(NotImplementedError, match="Slice 6b"):
        tcap.run_caption_eval(None, [], references={}, bertscorer=object())
    with pytest.raises(NotImplementedError, match="Slice 6b"):
        tcli.main(["--synthetic", "--device", "cpu", "--use_bertscore",
                   "--output_dir", str(tmp_path)])


def test_cli_writes_the_reference_baseline_rows(tmp_path):
    flags = ["--models", "knn", "mlp", "random", "--tasks", "retrieval",
             "qa", "--n_bootstrap", "60"]
    assert tcli.main(["--synthetic", "--device", "cpu", "--output_dir",
                      str(tmp_path / "port"), *flags]) == 0
    jscript = jax_eval_script()
    datasets, ctx = jscript.synthetic_datasets(False)
    jcore.run_evaluation(jcore.EvalArgs(
        tasks=("retrieval", "qa"), models=("knn", "mlp", "random"),
        output_dir=str(tmp_path / "jax"),
        retrieval=jcore.ret.RetrievalEvalConfig(n_boot=60)), datasets,
        model_context=ctx)
    for task in ("retrieval", "qa"):
        with open(tmp_path / "port" / f"{task}_metrics.tsv") as f:
            port = f.read()
        with open(tmp_path / "jax" / f"{task}_metrics.tsv") as f:
            assert port == f.read()
        assert port.startswith("model\tdataset\tmetric\tvalue\n")


def test_qa_filter_captions_keeps_the_captions_at_the_threshold(tmp_path):
    """qa_filter_captions --synthetic --device cpu: every caption's
    yes-probability is that of ProcyonQAEval on the caption as the text,
    and the threshold keeps exactly those at or above it."""
    from procyon_tpu_torch.scripts import qa_filter_captions as qf
    src = tmp_path / "captions.csv"
    src.write_text("protein_id,caption\n3,binds atp in the cytosol\n"
                   "5,a membrane transporter of ions\n9,unknown function\n")
    rows = {}
    for threshold in ("0", "1.01"):
        out = tmp_path / f"kept_{threshold}.csv"
        assert qf.main(["--synthetic", "--device", "cpu", "--captions",
                        str(src), "--out", str(out), "--threshold",
                        threshold]) == 0
        with open(out) as f:
            rows[threshold] = [line.rstrip("\n").split(",")
                               for line in f]
    assert rows["1.01"] == [["protein_id", "caption", "qa_yes_prob"]]
    kept = rows["0"][1:]
    assert [r[0] for r in kept] == ["3", "5", "9"]
    probs = np.array([float(r[2]) for r in kept])
    assert ((probs > 0) & (probs < 1)).all() and len(set(probs)) == 3


CAPTIONS = [(3, "binds atp in the cytosol"),
            (5, "a membrane transporter of ions"),
            (9, "unknown function")]


def _jax_caption_probs(params, jcfg, rows, batch_size):
    """The JAX script's scoring loop (scripts/qa_filter_captions.py): the
    QA collator over a store whose texts at 10**9 + n are the captions,
    unified.forward's logits at [ANSWER], qa_yes_prob."""
    import jax
    import jax.numpy as jnp

    from procyon_tpu.data import collators as jC
    from procyon_tpu.data import instruct as jinstruct
    from procyon_tpu.data.text_tokenizer import load_tokenizer
    from procyon_tpu.evaluate.qa import qa_yes_prob
    from procyon_tpu.models import unified as juni

    base = jD.SyntheticStore(n_proteins=16, embed_dim=TABLE_DIM)
    caps = {10 ** 9 + n: cap for n, (_, cap) in enumerate(rows)}

    class Store:
        def protein_sequence(self, i):
            return base.protein_sequence(i)

        def protein_embedding(self, i):
            return base.protein_embedding(i)

        def text(self, i):
            return caps.get(i, base.text(i))

    tok = load_tokenizer(vocab_size=VOCAB)
    task = jinstruct.TaskLibrary().get("uniprot_all_qa")
    coll = jC.QACollator(jC.CollatorConfig(
        protein_embed_dim=jcfg.encoder_out_dim), tok, Store(), task)
    prompt = jinstruct.get_prompt(task, num_examples=1)
    forward = jax.jit(lambda p, b: juni.forward(p, jcfg, b)["logits"])
    probs = []
    for i in range(0, len(rows), batch_size):
        chunk = rows[i:i + batch_size]
        batch = coll([(pid, 10 ** 9 + i + n, True)
                      for n, (pid, _) in enumerate(chunk)], prompt)
        logits = np.asarray(forward(params, {
            k: jnp.asarray(v) for k, v in batch.items()
            if k != "reference_indices" and not np.isscalar(v)}),
            np.float32)
        at = logits[np.arange(len(chunk)), batch["answer_pos"]]
        probs.extend(qa_yes_prob(at, tok.spec.yes_id, tok.spec.no_id))
    return np.array(probs)


def test_qa_filter_scores_match_the_reference_script():
    import jax

    import procyon_tpu.models.unified as juni
    from procyon_tpu_torch.scripts import qa_filter_captions as qf
    jcfg, tcfg = tiny_configs()
    params = juni.init_params(jax.random.PRNGKey(8), jcfg)
    tparams = bridge.to_torch(params)

    def port(rows):
        out = qf.score_captions(
            tparams, tcfg, tload_tokenizer(vocab_size=VOCAB),
            tD.SyntheticStore(n_proteins=16, embed_dim=TABLE_DIM), rows,
            task=tinstruct.TaskLibrary().get("uniprot_all_qa"),
            batch_size=2, device="cpu")
        assert [(a, c) for a, c, _ in out] == rows
        return np.array([p for _, _, p in out])

    got = port(CAPTIONS)
    want = _jax_caption_probs(params, jcfg, CAPTIONS, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # another caption for protein 5: its own probability moves, the rest
    # stay
    rows = list(CAPTIONS)
    rows[1] = (5, "a nuclear transcription factor of the heat shock")
    moved = port(rows)
    np.testing.assert_allclose(
        moved, _jax_caption_probs(params, jcfg, rows, 2), atol=1e-4, rtol=0)
    assert abs(moved[1] - got[1]) > 1e-4
    np.testing.assert_allclose(moved[[0, 2]], got[[0, 2]], atol=1e-6,
                               rtol=0)
