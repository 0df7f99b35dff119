"""Evaluation orchestration (counterpart of procyon_tpu/evaluate/core.py).

Equivalent of procyon/evaluate/framework/core.py: `run_evaluation` loops
over (task x model x dataset), dispatches to the per-task runner, and writes
metrics incrementally (:202-240); the model zoo (:68-110) maps model-type
names to constructors per task family.

The zoo holds ProCyon itself, the simple baselines (random, knn, mlp,
blast) and the third-party ones (biotranslator, protst, pubmedbert,
simcse for retrieval, protllm for QA). A third-party entry takes the
towers preloaded in the context under its name, or else builds seeded
synthetic ones on the context's "device" (the ProCyon entry's, else
"cuda"): no released checkpoint is at hand.
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from procyon_tpu_torch.evaluate import caption as cap
from procyon_tpu_torch.evaluate import qa as qa_mod
from procyon_tpu_torch.evaluate import retrieval as ret
from procyon_tpu_torch.evaluate.utils import PredictionCache, write_metrics

@dataclasses.dataclass
class EvalArgs:
    """Equivalent of procyon/evaluate/framework/args.py EvalArgs."""
    tasks: Sequence[str] = ("retrieval", "qa", "caption")
    models: Sequence[str] = ("procyon",)
    output_dir: str = "eval_out"
    cache_dir: Optional[str] = None
    use_cached_results: bool = True
    retrieval: ret.RetrievalEvalConfig = dataclasses.field(
        default_factory=ret.RetrievalEvalConfig)
    use_bertscore: bool = False


# model zoo: task -> {model_name: constructor(ctx, ds) -> model}
# ds is the current dataset entry (the reference constructs a fresh model
# wrapper per (task, model, dataset) iteration, framework/core.py:202-240).
MODEL_ZOO: Dict[str, Dict[str, Callable]] = {
    "retrieval": {},
    "qa": {},
    "caption": {},
}


def register_model(task: str, name: str, constructor: Callable):
    MODEL_ZOO[task][name] = constructor


def _procyon_ctx(ctx, ds):
    """Shared pieces for the ProCyon wrappers: ctx["procyon"] carries
    params / cfg / tokenizer / store and the device (loaded once); ds
    carries the per-dataset instruct task JSON."""
    p = ctx["procyon"]
    task_json = ds.get("task_json") or ctx.get("task_json")
    if task_json is None:
        raise KeyError(
            "procyon eval needs a task_json (instruct task dict) on the "
            "dataset entry or model context")
    store = ds.get("store") or p.get("store")
    return p, task_json, store


def _default_zoo():
    from procyon_tpu_torch.evaluate.baselines import (
        KNNQAModel, KNNRetrievalModel, MLPRetrievalModel, RandomQAModel,
        RandomRetrievalModel, ScoreMatrixRetrievalModel)
    from procyon_tpu_torch.evaluate.procyon_models import (
        ProcyonCaptionEval, ProcyonQAEval, ProcyonRetrievalEval)

    if "random" in MODEL_ZOO["retrieval"]:
        return
    register_model("retrieval", "random",
                   lambda ctx, ds: RandomRetrievalModel())
    register_model("qa", "random", lambda ctx, ds: RandomQAModel())

    def _train_rel(ctx, ds):
        # per-dataset train relations when the loader attached them
        # (the reference builds kNN per dataset, knn.py:43-127)
        return ds.get("train_relations") or ctx["train_relations"]

    register_model(
        "retrieval", "knn",
        lambda ctx, ds: KNNRetrievalModel(ctx["protein_embeddings"],
                                          _train_rel(ctx, ds)))
    register_model(
        "qa", "knn",
        lambda ctx, ds: KNNQAModel(ctx["protein_embeddings"],
                                   _train_rel(ctx, ds)))
    register_model(
        "retrieval", "mlp",
        lambda ctx, ds: MLPRetrievalModel(ctx["protein_embeddings"],
                                          _train_rel(ctx, ds)))
    # BLAST bit-score retrieval over a precomputed matrix (blast.py:26-88).
    # As in the JAX package, "query_ids" is handed over as the protein
    # index ({protein id: matrix row}) and "target_ids" as the train
    # relations (ROADMAP.md, section 3).
    register_model(
        "retrieval", "blast",
        lambda ctx, ds: ScoreMatrixRetrievalModel(
            ctx["blast_scores"]["matrix"],
            ctx["blast_scores"]["query_ids"],
            ctx["blast_scores"]["target_ids"]))

    def _ret(ctx, ds):
        p, task_json, store = _procyon_ctx(ctx, ds)
        return ProcyonRetrievalEval(
            p["params"], p["cfg"], p["tokenizer"], store, task_json,
            batch_size=p.get("batch_size", 16),
            target_cache_path=p.get("target_cache_path"),
            collator_cfg=p.get("collator_cfg"),
            device=p.get("device", "cuda"))

    def _qa(ctx, ds):
        p, task_json, store = _procyon_ctx(ctx, ds)
        return ProcyonQAEval(p["params"], p["cfg"], p["tokenizer"], store,
                             task_json, batch_size=p.get("batch_size", 16),
                             collator_cfg=p.get("collator_cfg"),
                             device=p.get("device", "cuda"))

    def _cap(ctx, ds):
        p, task_json, store = _procyon_ctx(ctx, ds)
        return ProcyonCaptionEval(p["params"], p["cfg"], p["tokenizer"],
                                  store, task_json,
                                  batch_size=p.get("batch_size", 8),
                                  gen=p.get("generation_config"),
                                  collator_cfg=p.get("collator_cfg"),
                                  device=p.get("device", "cuda"))

    register_model("retrieval", "procyon", _ret)
    register_model("qa", "procyon", _qa)
    register_model("caption", "procyon", _cap)

    # third-party baseline families (reference zoo entries BioTranslator /
    # ProtST / ProtLLM, framework/core.py:68-110; the SimCSE / PubMedBERT
    # text encoders of procyon/model/{simcse,pubmedbert}.py as the
    # text_encoder baselines). ctx may carry preloaded towers under the
    # model name; otherwise seeded synthetic weights run the whole path.
    from procyon_tpu_torch.evaluate.baselines.protllm import ProtLLMQAEval
    from procyon_tpu_torch.evaluate.baselines.text_models import (
        BioTranslatorRetrievalEval, ProtSTRetrievalEval,
        TextEncoderRetrievalEval)

    def _store(ctx, ds):
        s = ds.get("store") or ctx.get("store")
        if s is None and "procyon" in ctx:
            s = ctx["procyon"].get("store")
        if s is None:
            raise KeyError("baseline model needs a text/sequence store on "
                           "the dataset entry or model context")
        return s

    def _device(ctx):
        return ctx.get("device") or ctx.get("procyon", {}).get("device") \
            or "cuda"

    def _biotranslator(ctx, ds):
        pre = ctx.get("biotranslator")
        if pre is not None:
            return BioTranslatorRetrievalEval(
                pre["text_tower"], pre["cnn_params"], pre["cnn_cfg"],
                _store(ctx, ds), **pre.get("kw", {}))
        return BioTranslatorRetrievalEval.synthetic(_store(ctx, ds),
                                                    device=_device(ctx))

    def _protst(ctx, ds):
        pre = ctx.get("protst")
        if pre is not None:
            return ProtSTRetrievalEval(
                pre["text_tower"], pre["esm_params"], pre["esm_cfg"],
                pre["graph_proj"], _store(ctx, ds), **pre.get("kw", {}))
        return ProtSTRetrievalEval.synthetic(_store(ctx, ds),
                                             device=_device(ctx))

    def _text_encoder(name):
        def ctor(ctx, ds):
            store = _store(ctx, ds)
            # target proteins are represented by their functional
            # descriptions when the context provides them; the sequence
            # string is the (weak) fallback
            text_fn = ctx.get("protein_text_fn") or \
                (lambda a: " ".join(store.protein_sequence(a)))
            pre = ctx.get(name)
            if pre is not None:
                model = TextEncoderRetrievalEval(pre["tower"], store,
                                                 text_fn)
            else:
                model = TextEncoderRetrievalEval.synthetic(
                    store, text_fn, device=_device(ctx))
            # the prediction cache is keyed by the model's name: under the
            # class's one name ("text_encoder", as in the reference)
            # simcse would read back pubmedbert's cached scores
            model.name = name
            return model
        return ctor

    def _protllm(ctx, ds):
        pre = ctx.get("protllm")
        if pre is not None:
            return ProtLLMQAEval(
                pre["esm_params"], pre["esm_cfg"], pre["llama_params"],
                pre["llama_cfg"], pre["projector"], pre["tokenizer"],
                _store(ctx, ds), **pre.get("kw", {}))
        return ProtLLMQAEval.synthetic(_store(ctx, ds), device=_device(ctx))

    register_model("retrieval", "biotranslator", _biotranslator)
    register_model("retrieval", "protst", _protst)
    register_model("retrieval", "pubmedbert", _text_encoder("pubmedbert"))
    register_model("retrieval", "simcse", _text_encoder("simcse"))
    register_model("qa", "protllm", _protllm)


def run_evaluation(args: EvalArgs, datasets: Dict[str, Dict], *,
                   model_context: Optional[Dict] = None) -> List[Dict]:
    """datasets: {dataset_name: {"task": ..., "eval_relations": [...],
    "query_order": [...], "all_protein_ids": [...], "train_leak_pairs": ...,
    "qa_samples": [...], "caption_targets": [...], "references": {...}}}

    model_context: shared resources for zoo constructors (embeddings, params,
    tokenizer, ...).
    """
    _default_zoo()
    ctx = model_context or {}
    cache = PredictionCache(args.cache_dir if args.use_cached_results
                            else None)
    results = []
    for ds_name, ds in datasets.items():
        task = ds["task"]
        if task not in args.tasks:
            continue
        for model_name in args.models:
            ctor = MODEL_ZOO[task].get(model_name)
            if ctor is None:
                continue
            model = ctor(ctx, ds)
            if task == "retrieval":
                metrics = ret.run_retrieval_eval(
                    model, ds, all_protein_ids=ds["all_protein_ids"],
                    eval_relations=ds["eval_relations"],
                    query_order=ds["query_order"],
                    cfg=args.retrieval,
                    train_leak_pairs=ds.get("train_leak_pairs"),
                    cache=cache, dataset_name=ds_name)
            elif task == "qa":
                metrics = qa_mod.run_qa_eval(
                    model, ds["qa_samples"], cache=cache,
                    dataset_name=ds_name)
            elif task == "caption":
                metrics = cap.run_caption_eval(
                    model, ds["caption_targets"],
                    references=ds["references"],
                    use_bertscore=args.use_bertscore,
                    bertscorer=ctx.get("bertscorer"),
                    dataset_name=ds_name)
            else:
                continue
            write_metrics(args.output_dir, task, model_name, ds_name,
                          metrics)
            results.append({"task": task, "model": model_name,
                            "dataset": ds_name, "metrics": metrics})
    return results
