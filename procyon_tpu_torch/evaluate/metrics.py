"""Evaluation metrics (counterpart of procyon_tpu/evaluate/metrics.py),
numpy only.

Ported so far: `bootstrap_ci` and `f1_macro` (the QA metrics' macro-F1,
which the reference takes from scikit-learn; the port computes it here so
that it needs no scikit-learn, and the tests hold it to scikit-learn's).
The retrieval and caption metrics wait for the evaluation slice
(ROADMAP.md, queue 1).
"""

from typing import Tuple

import numpy as np


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
