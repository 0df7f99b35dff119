"""Benchmark evaluation CLI (counterpart of scripts/run_eval_framework.py).

Args (flags or --from_yaml) -> evaluate/core.run_evaluation over (task x
model x dataset), metrics written to {task}_metrics.tsv under --output_dir
incrementally, one JSON line a (task, model, dataset) on stdout. The
ProCyon model is a zoo entry like the baselines: pass --models procyon and
either a model directory (--model_dir, models/checkpoint_io.load_model)
over DATA_DIR, or --synthetic (three blobs of 30 proteins and a tiny random
ProCyon model: bf16 on the card, f32 with --device cpu).

Synthetic runs:
  python -m procyon_tpu_torch.scripts.run_eval_framework --synthetic \\
      --output_dir eval1 [--device cpu]
  python -m procyon_tpu_torch.scripts.run_eval_framework --synthetic \\
      --models procyon knn mlp random --tasks retrieval qa caption
Real data (DATA_DIR layout and a model directory):
  python -m procyon_tpu_torch.scripts.run_eval_framework \\
      --data_dir $DATA_DIR --model_dir <dir> \\
      --datasets '[{"text_type": "disgenet", "tasks": ["retrieval","qa"]}]'

Caption BERTScore: --use_bertscore (the synthetic-weight scorer, or a
local SciBERT checkpoint with --bertscore_model_dir; --bertscore_layer,
--bertscore_baseline_file from compute_bertscore_baseline), on --device.
The third-party baselines (--models biotranslator protst pubmedbert simcse
protllm) run with seeded synthetic towers on --device in a synthetic run.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--from_yaml", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output_dir", type=str, default="eval_out")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--tasks", nargs="+",
                   default=["retrieval", "qa"])
    p.add_argument("--models", nargs="+", default=["knn", "random"])
    # real-data path (evaluate/framework/utils.py:163 load_datasets_for_eval)
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("DATA_DIR"))
    p.add_argument("--model_dir", type=str, default=None,
                   help="model directory (checkpoint_io layout)")
    p.add_argument("--datasets", type=str, default=None,
                   help="JSON list of {aaseq_type, text_type, relation, "
                        "tasks} entries")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--train_split", type=str, default="train")
    p.add_argument("--split_method", type=str, default="random_split")
    p.add_argument("--batch_size", type=int, default=16)
    # caption BERTScore (evaluate/bertscore.py)
    p.add_argument("--use_bertscore", action="store_true")
    p.add_argument("--bertscore_model_dir", type=str, default=None,
                   help="local HF BERT / SciBERT checkpoint directory "
                        "(weights and vocab.txt); omitted: the "
                        "synthetic-weight scorer")
    p.add_argument("--bertscore_layer", type=int, default=None)
    p.add_argument("--bertscore_baseline_file", type=str, default=None,
                   help="rescaling constants (compute_bertscore_baseline): "
                        "bertscore_* reported as (s - b) / (1 - b), the "
                        "reference's rescale_with_baseline=True")
    # retrieval-eval knobs (reference EvalArgs surface, framework/args.py)
    p.add_argument("--retrieval_top_k", type=int, nargs="+", default=None,
                   help="top-k list for precision/recall@k")
    p.add_argument("--n_bootstrap", type=int, default=None)
    p.add_argument("--max_num_queries", type=int, default=None)
    p.add_argument("--num_class_balanced_samples", type=int, default=None)
    p.add_argument("--negatives_per_positive", type=int, default=None)
    # remaining reference EvalArgs surface (framework/args.py)
    p.add_argument("--qa_num_samples", type=int, default=None,
                   help="cap QA samples per dataset (linear scan)")
    p.add_argument("--caption_max_len", type=int, default=None,
                   help="max new tokens for caption generation")
    p.add_argument("--seed", type=int, default=42,
                   help="subsampling seed")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the models run (cuda unless told "
                        "otherwise)")
    args = p.parse_args(argv)
    if args.from_yaml:
        import yaml

        with open(args.from_yaml) as f:
            for k, v in (yaml.safe_load(f) or {}).items():
                if hasattr(args, k):
                    setattr(args, k, v)
    return args


def synthetic_datasets(with_procyon: bool, device="cuda"):
    """Three blobs of 30 proteins (one query text each), split in halves
    for train and eval; with_procyon adds a tiny random ProCyon model on
    `device` whose store holds the blobs' embeddings."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((3, 32)) * 5
    embeds, relations = {}, []
    pid = 0
    for c in range(3):
        for _ in range(30):
            embeds[pid] = centers[c] + rng.standard_normal(32) * 0.3
            relations.append((pid, 1000 + c))
            pid += 1
    train = [r for i, r in enumerate(relations) if i % 2 == 0]
    test = [r for i, r in enumerate(relations) if i % 2 == 1]
    qa_samples = [(a, t, 1) for a, t in test] + \
        [(a, 1000 + (t - 999) % 3, 0) for a, t in test]
    from procyon_tpu_torch.evaluate.utils import get_train_relations_for_eval

    queries = [1000, 1001, 1002]
    leaks = get_train_relations_for_eval(train, queries, list(embeds))
    caption_targets = sorted({a for a, _ in test})[:4]
    references = {a: ["synthetic phenotype description number "
                      f"{t % 64} involving pathway p{t % 7} and function "
                      f"f{t % 11}" for at, t in test if at == a] or
                  ["synthetic reference"] for a in caption_targets}
    datasets = {
        "synthetic_retrieval": {
            "task": "retrieval", "eval_relations": test,
            "query_order": queries, "all_protein_ids": list(embeds),
            "train_leak_pairs": leaks},
        "synthetic_qa": {"task": "qa", "qa_samples": qa_samples},
        "synthetic_caption": {"task": "caption",
                              "caption_targets": caption_targets,
                              "references": references},
    }
    ctx = {"protein_embeddings": embeds, "train_relations": train}

    if with_procyon:
        import torch

        from procyon_tpu_torch.data import datasets as D
        from procyon_tpu_torch.data import instruct
        from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
        from procyon_tpu_torch.models import llama, unified

        device = torch.device(device)
        # f32 on the CPU; on the card bf16, the type the attention kernels
        # take (head_dim 32 is one of the flash kernel's)
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
        cfg = unified.UnifiedConfig(
            llama=llama.LlamaConfig(vocab_size=4096, dim=128, n_layers=2,
                                    n_heads=4, n_kv_heads=2,
                                    intermediate=256, max_seq_len=512,
                                    dtype=dtype),
            esm=None, protein_embed_dim=32, token_projector_layers=2,
            token_projector_hidden=64, retrieval_dim=32, dtype=dtype)
        params = unified.init_params(0, cfg, device=device)
        store = D.SyntheticStore(n_proteins=len(embeds), n_texts=1024,
                                 embed_dim=32)
        # align the store's embeddings with the blob clusters so all models
        # see the same protein space
        store._embeds = np.stack([embeds[i] for i in sorted(embeds)]
                                 ).astype(np.float32)
        lib = instruct.TaskLibrary()
        for name, task in (("synthetic_retrieval", "retrieval"),
                           ("synthetic_qa", "qa"),
                           ("synthetic_caption", "caption")):
            datasets[name]["task_json"] = lib.get(f"disgenet_all_{task}")
        ctx["procyon"] = {"params": params, "cfg": cfg,
                          "tokenizer": load_tokenizer(vocab_size=4096),
                          "store": store, "device": device}
    return datasets, ctx


def real_datasets(args):
    """DATA_DIR-layout datasets and the model context
    (framework/core.py:140-198 + utils.py:163)."""
    from procyon_tpu_torch.data.datasets import ProCyonDataStore
    from procyon_tpu_torch.evaluate.data_loading import \
        load_datasets_for_eval

    if not args.data_dir:
        raise SystemExit("--data_dir (or DATA_DIR env) required for "
                         "real-data eval; use --synthetic otherwise")
    entries = json.loads(args.datasets) if args.datasets else [
        {"text_type": "disgenet", "tasks": list(args.tasks)}]
    store = ProCyonDataStore(args.data_dir)
    datasets = load_datasets_for_eval(
        args.data_dir, entries, store=store, split=args.split,
        train_split=args.train_split, split_method=args.split_method)

    ctx = {}
    if any(m in ("knn", "mlp") for m in args.models):
        all_ids = sorted({i for ds in datasets.values()
                          for i in ds.get("all_protein_ids", [])})
        ctx["protein_embeddings"] = {
            i: store.protein_embedding(i) for i in all_ids}
        ctx["train_relations"] = [
            r for ds in datasets.values()
            for r in ds.get("train_relations", [])]
    if "procyon" in args.models:
        if not args.model_dir:
            raise SystemExit("--model_dir (a model directory) required "
                             "for --models procyon on real data")
        from procyon_tpu_torch.models.checkpoint_io import load_model

        params, cfg, tokenizer = load_model(args.model_dir,
                                            device=args.device)
        if tokenizer is None:
            raise SystemExit(f"{args.model_dir} has no tokenizer.json: "
                             "save it with tokenizer_info")
        cache = os.path.join(args.cache_dir or args.output_dir,
                             "target_embeddings.pkl")
        ctx["procyon"] = {"params": params, "cfg": cfg,
                          "tokenizer": tokenizer, "store": store,
                          "batch_size": args.batch_size,
                          "target_cache_path": cache,
                          "device": args.device}
    return datasets, ctx


BASELINES_NEEDING_STORE = {"biotranslator", "protst", "pubmedbert",
                           "simcse", "protllm"}


def main(argv=None):
    args = parse_args(argv)
    from procyon_tpu_torch.evaluate import core

    if args.synthetic:
        datasets, ctx = synthetic_datasets("procyon" in args.models,
                                           args.device)
        if BASELINES_NEEDING_STORE & set(args.models) \
                and "store" not in ctx:
            from procyon_tpu_torch.data import datasets as D

            ctx["store"] = ctx.get("procyon", {}).get("store") or \
                D.SyntheticStore(n_proteins=90, n_texts=1024, embed_dim=32)
    else:
        datasets, ctx = real_datasets(args)

    if args.qa_num_samples is not None:
        for ds in datasets.values():
            if ds.get("task") == "qa" and "qa_samples" in ds:
                ds["qa_samples"] = ds["qa_samples"][:args.qa_num_samples]
    if args.caption_max_len is not None and "procyon" in ctx:
        from procyon_tpu_torch.inference.generation import GenerationConfig

        tok = ctx["procyon"]["tokenizer"]
        ctx["procyon"]["generation_config"] = GenerationConfig(
            max_new_tokens=args.caption_max_len, method="beam",
            beam_size=10, beam_group_size=2, diversity_penalty=0.8,
            eos_token_id=tok.spec.eos_id, pad_token_id=tok.spec.pad_id)
    ctx["device"] = args.device

    if args.use_bertscore and "caption" in args.tasks:
        from procyon_tpu_torch.evaluate.bertscore import make_scorer

        kw = {} if args.bertscore_layer is None else \
            {"layer": args.bertscore_layer}
        ctx["bertscorer"] = make_scorer(
            args.bertscore_model_dir,
            baseline_file=args.bertscore_baseline_file, device=args.device,
            **kw)

    ret_cfg = core.ret.RetrievalEvalConfig()
    overrides = {}
    if args.retrieval_top_k is not None:
        overrides["top_ks"] = tuple(args.retrieval_top_k)
    if args.n_bootstrap is not None:
        overrides["n_boot"] = args.n_bootstrap
    if args.max_num_queries is not None:
        overrides["max_num_queries"] = args.max_num_queries
        overrides["query_subsample_seed"] = args.seed
    if args.num_class_balanced_samples is not None:
        overrides["num_resamples"] = args.num_class_balanced_samples
    if args.negatives_per_positive is not None:
        overrides["negs_per_pos"] = args.negatives_per_positive
    if overrides:
        ret_cfg = dataclasses.replace(ret_cfg, **overrides)

    eval_args = core.EvalArgs(tasks=tuple(args.tasks),
                              models=tuple(args.models),
                              output_dir=args.output_dir,
                              cache_dir=args.cache_dir,
                              use_bertscore=args.use_bertscore,
                              retrieval=ret_cfg)
    results = core.run_evaluation(eval_args, datasets, model_context=ctx)
    for r in results:
        brief = {k: round(v, 4) for k, v in r["metrics"].items()
                 if isinstance(v, float)}
        print(json.dumps({"task": r["task"], "model": r["model"],
                          "dataset": r["dataset"], **brief}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
