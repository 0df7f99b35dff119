"""Evaluation metrics (counterpart of procyon_tpu/evaluate/metrics.py),
numpy only.

  * fmax_score: CAFA protein-centric Fmax over score thresholds
  * precision_recall_topk: NaN-aware top-k precision / recall
  * per_query_auroc_auprc, auroc_auprc_from_scores,
    class_balanced_resample_metrics: the retrieval AUROC / AUPRC
  * bootstrap_ci, and f1_macro for the QA metrics
  * rouge_l, bleu: the caption metrics

All metrics are NaN-aware: NaN labels mark (query, target) pairs excluded
from scoring (train-leak masking, retrieval.prep_for_retrieval_eval).

The reference takes AUROC, average precision and the macro-F1 from
scikit-learn. The port computes them here (`roc_auc`, `average_precision`,
`f1_macro`) so that it needs no scikit-learn, and the tests hold each to
scikit-learn's, ties included.
"""

from collections import Counter
from typing import Tuple

import numpy as np


def _ranked_counts(y_true, y_score):
    """Cumulative true and false positives at each distinct score, from the
    highest down: (tps, fps), each [n_distinct]."""
    y = np.asarray(y_true) == 1
    s = np.asarray(y_score, float)
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(s)), s.size - 1]
    tps = np.cumsum(y, dtype=float)[last]
    fps = (last + 1) - tps
    return tps, fps


def roc_auc(y_true, y_score) -> float:
    """Area under the ROC curve by the trapezoid over the distinct score
    thresholds: the Mann-Whitney statistic with a tied (positive, negative)
    pair counted one half (scikit-learn's roc_auc_score). Needs both
    classes."""
    tps, fps = _ranked_counts(y_true, y_score)
    if tps[-1] == 0 or fps[-1] == 0:
        raise ValueError("roc_auc needs a positive and a negative label")
    tpr = np.r_[0.0, tps / tps[-1]]
    fpr = np.r_[0.0, fps / fps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def average_precision(y_true, y_score) -> float:
    """Average precision as the step sum over the distinct score
    thresholds, from the highest down, of (R_n - R_{n-1}) P_n, with no
    interpolation (scikit-learn's average_precision_score). Needs a
    positive label."""
    tps, fps = _ranked_counts(y_true, y_score)
    if tps[-1] == 0:
        raise ValueError("average_precision needs a positive label")
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def fmax_score(labels: np.ndarray, scores: np.ndarray,
               n_thresholds: int = 101) -> Tuple[float, float]:
    """CAFA Fmax: max over thresholds t of F1 with precision averaged over
    queries with >=1 prediction and recall over all queries.

    labels, scores: [Q, T]; NaN labels excluded. Returns (fmax, best_t).
    """
    valid = ~np.isnan(labels)
    y = np.where(valid, labels, 0).astype(bool)
    finite = scores[np.isfinite(scores) & valid]
    if finite.size == 0:
        return 0.0, 0.0
    lo, hi = finite.min(), finite.max()
    thresholds = np.linspace(lo, hi, n_thresholds)
    best_f, best_t = 0.0, float(thresholds[0])
    for t in thresholds:
        pred = (scores >= t) & valid
        tp = (pred & y).sum(axis=1).astype(float)
        npred = pred.sum(axis=1)
        npos = y.sum(axis=1)
        has_pred = npred > 0
        if has_pred.sum() == 0:
            continue
        prec = (tp[has_pred] / npred[has_pred]).mean()
        has_pos = npos > 0
        rec = (tp[has_pos] / npos[has_pos]).mean() if has_pos.any() else 0.0
        if prec + rec == 0:
            continue
        f = 2 * prec * rec / (prec + rec)
        if f > best_f:
            best_f, best_t = float(f), float(t)
    return best_f, best_t


def precision_recall_topk(labels: np.ndarray, scores: np.ndarray, k: int,
                          per_query: bool = False):
    """Top-k precision/recall per query, NaN-aware.

    For each query: rank targets by score among valid (non-NaN) pairs, take
    top k, compute precision = hits/k', recall = hits/positives.
    """
    Q = labels.shape[0]
    precs, recs = np.zeros(Q), np.zeros(Q)
    counted = np.zeros(Q, bool)
    for qi in range(Q):
        valid = ~np.isnan(labels[qi])
        if valid.sum() == 0:
            continue
        s = scores[qi][valid]
        y = labels[qi][valid].astype(bool)
        kk = min(k, s.size)
        order = np.argsort(-s)[:kk]
        hits = y[order].sum()
        npos = y.sum()
        precs[qi] = hits / kk
        recs[qi] = hits / npos if npos > 0 else np.nan
        counted[qi] = npos > 0
    if per_query:
        return precs, recs
    return (float(precs[counted].mean()) if counted.any() else 0.0,
            float(np.nanmean(recs[counted])) if counted.any() else 0.0)


def per_query_auroc_auprc(labels: np.ndarray, scores: np.ndarray):
    """Mean AUROC/AUPRC over queries with both classes present."""
    aurocs, auprcs = [], []
    for qi in range(labels.shape[0]):
        valid = ~np.isnan(labels[qi])
        y = labels[qi][valid]
        s = scores[qi][valid]
        if y.size == 0 or y.min() == y.max():
            continue
        aurocs.append(roc_auc(y, s))
        auprcs.append(average_precision(y, s))
    return (float(np.mean(aurocs)) if aurocs else float("nan"),
            float(np.mean(auprcs)) if auprcs else float("nan"))


def auroc_auprc_from_scores(pos_scores: np.ndarray, neg_scores: np.ndarray):
    """Train-time contrastive metrics: AUROC/AUPRC from flat
    positive/negative score arrays."""
    y = np.concatenate([np.ones(len(pos_scores)), np.zeros(len(neg_scores))])
    s = np.concatenate([pos_scores, neg_scores])
    if y.min() == y.max():
        return float("nan"), float("nan")
    return float(roc_auc(y, s)), float(average_precision(y, s))


def class_balanced_resample_metrics(labels: np.ndarray, scores: np.ndarray,
                                    *, n_samples: int = 5,
                                    neg_per_pos: int = 10, seed: int = 0):
    """Class-balanced negative resampling: per query, repeatedly sample
    neg_per_pos negatives per positive and average AUROC/AUPRC across
    samples."""
    rng = np.random.default_rng(seed)
    aurocs, auprcs = [], []
    for _ in range(n_samples):
        sample_aurocs, sample_auprcs = [], []
        for qi in range(labels.shape[0]):
            valid = ~np.isnan(labels[qi])
            y = labels[qi][valid]
            s = scores[qi][valid]
            pos_idx = np.where(y > 0)[0]
            neg_idx = np.where(y == 0)[0]
            if pos_idx.size == 0 or neg_idx.size == 0:
                continue
            n_neg = min(neg_per_pos * pos_idx.size, neg_idx.size)
            sel_neg = rng.choice(neg_idx, n_neg, replace=False)
            idx = np.concatenate([pos_idx, sel_neg])
            sample_aurocs.append(roc_auc(y[idx], s[idx]))
            sample_auprcs.append(average_precision(y[idx], s[idx]))
        if sample_aurocs:
            aurocs.append(np.mean(sample_aurocs))
            auprcs.append(np.mean(sample_auprcs))
    return (float(np.mean(aurocs)) if aurocs else float("nan"),
            float(np.mean(auprcs)) if auprcs else float("nan"))


def bootstrap_ci(values: np.ndarray, *, n_boot: int = 1000,
                 alpha: float = 0.05, seed: int = 0,
                 statistic=np.mean) -> Tuple[float, float, float]:
    """Percentile bootstrap CI over per-sample values: (point, low, high);
    NaNs are dropped, and all three are NaN when nothing is left."""
    values = np.asarray(values, float)
    values = values[~np.isnan(values)]
    if values.size == 0:
        return float("nan"), float("nan"), float("nan")
    rng = np.random.default_rng(seed)
    stats = np.array([
        statistic(values[rng.integers(0, values.size, values.size)])
        for _ in range(n_boot)])
    point = float(statistic(values))
    return point, float(np.quantile(stats, alpha / 2)), \
        float(np.quantile(stats, 1 - alpha / 2))


def f1_macro(labels: np.ndarray, preds: np.ndarray) -> float:
    """Unweighted mean over the classes present in labels or preds of
    F1 = 2 tp / (2 tp + fp + fn) (scikit-learn's f1_score(average=
    "macro"); a class that is never predicted scores 0)."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    scores = []
    for c in np.union1d(labels, preds):
        tp = np.sum((preds == c) & (labels == c))
        fp = np.sum((preds == c) & (labels != c))
        fn = np.sum((preds != c) & (labels == c))
        scores.append(2 * tp / (2 * tp + fp + fn))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# Text-generation metrics
# ---------------------------------------------------------------------------


def _lcs_len(a, b):
    dp = np.zeros((len(b) + 1,), np.int32)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return int(dp[-1])


def rouge_l(candidate: str, references) -> float:
    """ROUGE-L F1 against the best-matching reference."""
    if isinstance(references, str):
        references = [references]
    c = candidate.split()
    best = 0.0
    for ref in references:
        r = ref.split()
        if not c or not r:
            continue
        lcs = _lcs_len(c, r)
        p = lcs / len(c)
        rec = lcs / len(r)
        if p + rec:
            best = max(best, 2 * p * rec / (p + rec))
    return best


def bleu(candidate: str, references, max_n: int = 4) -> float:
    """Corpus-style BLEU for a single candidate vs multi-references
    (smoothed; sacrebleu-compatible in spirit)."""
    if isinstance(references, str):
        references = [references]
    c = candidate.split()
    if not c:
        return 0.0
    log_precisions = []
    for n in range(1, max_n + 1):
        c_ngrams = Counter(tuple(c[i:i + n]) for i in range(len(c) - n + 1))
        if not c_ngrams:
            log_precisions.append(np.log(1e-9))
            continue
        max_ref = Counter()
        for ref in references:
            r = ref.split()
            r_ngrams = Counter(tuple(r[i:i + n])
                               for i in range(len(r) - n + 1))
            for g, cnt in r_ngrams.items():
                max_ref[g] = max(max_ref[g], cnt)
        clipped = sum(min(cnt, max_ref[g]) for g, cnt in c_ngrams.items())
        total = sum(c_ngrams.values())
        if clipped == 0:
            if n == 1:
                return 0.0  # no unigram overlap at all
            # smoothing only for higher-order n-grams
            log_precisions.append(np.log(1.0 / (2 * total)))
        else:
            log_precisions.append(np.log(clipped / total))
    ref_lens = [len(r.split()) for r in references]
    ref_len = min(ref_lens, key=lambda rl: (abs(rl - len(c)), rl))
    bp = 1.0 if len(c) >= ref_len else np.exp(1 - ref_len / max(len(c), 1))
    return float(bp * np.exp(np.mean(log_precisions)))
