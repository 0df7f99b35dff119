"""Eval dataset assembly (counterpart of
procyon_tpu/evaluate/data_loading.py), host code only.

Equivalent of procyon/evaluate/framework/utils.py:load_datasets_for_eval
(:163-242) + get_train_relations_for_eval_dataset (:299-410): build the
per-dataset dicts `core.run_evaluation` consumes from the DATA_DIR relation
CSVs (or synthetic fixtures), including train-leak masking pairs.
"""

from typing import Dict, Optional, Sequence

import numpy as np

from procyon_tpu_torch.data import datasets as D
from procyon_tpu_torch.evaluate.utils import get_train_relations_for_eval


def build_eval_dataset(*, eval_relations, train_relations,
                       all_protein_ids, task: str,
                       qa_negatives_per_positive: int = 1,
                       references: Optional[Dict] = None,
                       seed: int = 0) -> Dict:
    """One run_evaluation dataset entry from relation lists."""
    query_order = sorted({t for _, t in eval_relations})
    entry = {"task": task}
    if task == "retrieval":
        entry.update({
            "eval_relations": list(eval_relations),
            "query_order": query_order,
            "all_protein_ids": list(all_protein_ids),
            "train_leak_pairs": get_train_relations_for_eval(
                train_relations, query_order, list(all_protein_ids)),
        })
    elif task == "qa":
        rng = np.random.default_rng(seed)
        true_by_text = {}
        for a, t in list(train_relations) + list(eval_relations):
            true_by_text.setdefault(t, set()).add(a)
        samples = []
        ids = list(all_protein_ids)
        for a, t in eval_relations:
            samples.append((a, t, 1))
            for _ in range(qa_negatives_per_positive):
                neg = int(rng.choice(ids))
                while neg in true_by_text.get(t, ()):
                    neg = int(rng.choice(ids))
                samples.append((neg, t, 0))
        entry["qa_samples"] = samples
    elif task == "caption":
        refs = references or {}
        entry.update({
            "caption_targets": sorted({a for a, _ in eval_relations}),
            "references": refs,
        })
    return entry


def load_datasets_for_eval(data_dir: str, entries: Sequence[Dict], *,
                           store=None, split: str = "test",
                           train_split: str = "train",
                           split_method: str = "random_split",
                           task_library=None,
                           subset_version: int = 5) -> Dict:
    """entries: [{aaseq_type, text_type, relation, tasks: [...]}].
    Returns {dataset_name: run_evaluation entry}.

    Each entry also carries what the ProCyon zoo wrappers need
    (framework/core.py:202-240 builds a wrapper per dataset):
      task_json — the instruct task dict for the (dataset, task) pair
      store     — a TextTableStore bound to the dataset's composed columns
      text_type — for bookkeeping/TSV naming
    """
    from procyon_tpu_torch.data import instruct, registry

    base_store = store or D.ProCyonDataStore(data_dir)
    lib = task_library or instruct.TaskLibrary()
    out = {}
    for e in entries:
        aaseq_type = e.get("aaseq_type", "protein")
        relation = e.get("relation", "all")
        # named eval protocols (pt_ft / few_shot / zero_shot[_easy/_hard])
        # resolve PER DATASET (registry.SPLIT_MAPS; the reference's
        # framework/constants.py:1-120); raw split names pass through
        ds_split = registry.resolve_eval_split(aaseq_type, e["text_type"],
                                               split)
        ds_eval = D.AASeqTextRelationDataset.from_csv(
            data_dir, aaseq_type, e["text_type"],
            e.get("relation") and [e["relation"]], ds_split,
            split_method=split_method, store=base_store)
        ds_train = D.AASeqTextRelationDataset.from_csv(
            data_dir, aaseq_type, e["text_type"],
            e.get("relation") and [e["relation"]], train_split,
            split_method=split_method, store=base_store)
        eval_rel = [(r.aaseq_idx, r.text_idx) for r in ds_eval.relations]
        train_rel = [(r.aaseq_idx, r.text_idx) for r in ds_train.relations]
        all_ids = sorted({a for a, _ in eval_rel + train_rel})
        for task in e.get("tasks", ["retrieval", "qa"]):
            name = f"{e['text_type']}_{relation}_{task}"
            cols = registry.column_subset(task, e["text_type"],
                                          subset_version) or []
            tstore = D.TextTableStore(
                base_store if isinstance(base_store, D.ProCyonDataStore)
                else getattr(base_store, "base", base_store),
                e["text_type"], cols) \
                if isinstance(base_store, D.ProCyonDataStore) else base_store
            references = None
            if task == "caption":
                references = {}
                for a, t in eval_rel:
                    references.setdefault(a, []).append(tstore.text(t))
            entry = build_eval_dataset(
                eval_relations=eval_rel, train_relations=train_rel,
                all_protein_ids=all_ids, task=task, references=references)
            try:
                entry["task_json"] = lib.get(instruct.construct_task_id(
                    aaseq_type, e["text_type"].split(":")[0], relation,
                    task))
            except (KeyError, FileNotFoundError):
                entry["task_json"] = None
            entry["store"] = tstore
            entry["text_type"] = e["text_type"]
            entry["train_relations"] = train_rel
            out[name] = entry
    return out
