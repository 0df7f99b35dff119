"""Retrieval evaluation (counterpart of procyon_tpu/evaluate/retrieval.py),
host code only:
  * AbstractRetrievalModel: `get_predictions(queries, targets)` -> [Q, T]
    score matrix
  * get_target_set: all proteins or a subset
  * prep_for_retrieval_eval: binary label matrix from eval relations,
    train leaks NaN-masked
  * calc_retrieval_metrics: Fmax, top-k P/R, per-query AUROC / AUPRC,
    class-balanced resampling, bootstrap CIs
  * run_retrieval_eval: orchestration and prediction caching
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from procyon_tpu_torch.evaluate import metrics as M
from procyon_tpu_torch.evaluate.utils import PredictionCache


class AbstractRetrievalModel:
    """Interface every retrieval model implements."""

    name = "abstract"

    def get_predictions(self, query_order: Sequence[int],
                        target_order: Sequence[int],
                        dataset) -> np.ndarray:
        """Return [Q, T] scores (higher = more likely related)."""
        raise NotImplementedError


@dataclasses.dataclass
class RetrievalEvalConfig:
    top_ks: Tuple[int, ...] = (10, 20, 100)
    num_resamples: int = 5
    negs_per_pos: int = 10
    bootstrap: bool = True
    n_boot: int = 200
    target_subset: Optional[Sequence[int]] = None  # None = all proteins
    # deterministic query subsampling (the reference's EvalArgs
    # max_num_queries); None = evaluate every query
    max_num_queries: Optional[int] = None
    query_subsample_seed: int = 0


def get_target_set(all_protein_ids: Sequence[int],
                   eval_relations: Sequence[Tuple[int, int]],
                   cfg: RetrievalEvalConfig) -> List[int]:
    """All-protein target set or the configured subset, always including
    every positive target from the eval relations."""
    if cfg.target_subset is not None:
        targets = list(dict.fromkeys(cfg.target_subset))
        have = set(targets)
        for a in {a for a, _ in eval_relations}:
            if a not in have:
                targets.append(a)
                have.add(a)
        return targets
    return list(all_protein_ids)


def prep_for_retrieval_eval(
        eval_relations: Sequence[Tuple[int, int]],  # (aaseq, text) positives
        query_order: Sequence[int],                 # text ids (rows)
        target_order: Sequence[int],                # aaseq ids (cols)
        train_leak_pairs: Optional[Set[Tuple[int, int]]] = None,
) -> np.ndarray:
    """Binary [Q, T] label matrix; train-leak (qi, ti) pairs -> NaN."""
    qpos = {q: i for i, q in enumerate(query_order)}
    tpos = {t: i for i, t in enumerate(target_order)}
    labels = np.zeros((len(query_order), len(target_order)), np.float32)
    for a, t in eval_relations:
        if t in qpos and a in tpos:
            labels[qpos[t], tpos[a]] = 1.0
    if train_leak_pairs:
        for qi, ti in train_leak_pairs:
            labels[qi, ti] = np.nan
    return labels


def calc_retrieval_metrics(labels: np.ndarray, scores: np.ndarray,
                           cfg: RetrievalEvalConfig) -> Dict[str, float]:
    out: Dict[str, float] = {}
    fmax, t = M.fmax_score(labels, scores)
    out["fmax"] = fmax
    out["fmax_threshold"] = t
    for k in cfg.top_ks:
        p, r = M.precision_recall_topk(labels, scores, k)
        out[f"precision_at_{k}"] = p
        out[f"recall_at_{k}"] = r
    auroc, auprc = M.per_query_auroc_auprc(labels, scores)
    out["auroc"] = auroc
    out["auprc"] = auprc
    rb_auroc, rb_auprc = M.class_balanced_resample_metrics(
        labels, scores, n_samples=cfg.num_resamples,
        neg_per_pos=cfg.negs_per_pos)
    out["auroc_class_balanced"] = rb_auroc
    out["auprc_class_balanced"] = rb_auprc
    if cfg.bootstrap:
        # bootstrap over per-query AUPRC values
        per_q = []
        for qi in range(labels.shape[0]):
            valid = ~np.isnan(labels[qi])
            y = labels[qi][valid]
            s = scores[qi][valid]
            if y.size and y.min() != y.max():
                per_q.append(M.average_precision(y, s))
        point, lo, hi = M.bootstrap_ci(np.asarray(per_q), n_boot=cfg.n_boot)
        out["auprc_ci_low"] = lo
        out["auprc_ci_high"] = hi
    return out


def run_retrieval_eval(model: AbstractRetrievalModel, dataset, *,
                       all_protein_ids: Sequence[int],
                       eval_relations: Sequence[Tuple[int, int]],
                       query_order: Sequence[int],
                       cfg: RetrievalEvalConfig = RetrievalEvalConfig(),
                       train_leak_pairs=None,
                       cache: Optional[PredictionCache] = None,
                       dataset_name: str = "dataset") -> Dict[str, float]:
    if cfg.max_num_queries is not None \
            and len(query_order) > cfg.max_num_queries:
        rng = np.random.default_rng(cfg.query_subsample_seed)
        keep = sorted(rng.choice(len(query_order), cfg.max_num_queries,
                                 replace=False))
        remap = {old: new for new, old in enumerate(keep)}
        query_order = [query_order[i] for i in keep]
        if train_leak_pairs:
            # leak pairs are (query_row, target_col) indices - remap rows
            train_leak_pairs = {(remap[qi], ti)
                                for qi, ti in train_leak_pairs
                                if qi in remap}
    target_order = get_target_set(all_protein_ids, eval_relations, cfg)
    labels = prep_for_retrieval_eval(eval_relations, query_order,
                                     target_order, train_leak_pairs)
    scores = None
    if cache:
        try:
            scores = cache.load(model.name, dataset_name, query_order,
                                target_order)
        except ValueError:
            scores = None
    if scores is None:
        scores = np.asarray(model.get_predictions(query_order, target_order,
                                                  dataset))
        if cache:
            cache.save(model.name, dataset_name, scores, query_order,
                       target_order)
    assert scores.shape == labels.shape, (scores.shape, labels.shape)
    return calc_retrieval_metrics(labels, scores, cfg)
