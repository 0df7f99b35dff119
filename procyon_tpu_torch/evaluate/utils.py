"""Eval framework utilities (counterpart of procyon_tpu/evaluate/utils.py),
host code only: incremental TSV metric writing, prediction caching and the
train-relation lookup for leak masking; bootstrap_ci is re-exported from
metrics.py.
"""

import os
import pickle
from typing import Dict, Optional

import numpy as np

from procyon_tpu_torch.evaluate.metrics import bootstrap_ci  # noqa: F401


def write_metrics(out_dir: str, task: str, model_name: str,
                  dataset_name: str, metrics: Dict):
    """Append one row per metric to {task}_metrics.tsv (incremental,
    fault-tolerant: written after every (model, dataset) pair)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{task}_metrics.tsv")
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write("model\tdataset\tmetric\tvalue\n")
        for k, v in metrics.items():
            f.write(f"{model_name}\t{dataset_name}\t{k}\t{v}\n")


def read_metrics(out_dir: str, task: str):
    path = os.path.join(out_dir, f"{task}_metrics.tsv")
    rows = []
    with open(path) as f:
        f.readline()  # the header
        for line in f:
            model, dataset, metric, value = line.rstrip("\n").split("\t")
            rows.append({"model": model, "dataset": dataset,
                         "metric": metric, "value": float(value)})
    return rows


class PredictionCache:
    """On-disk cache of model predictions keyed by (model, dataset); checks
    that the row and column orders match on reload, so metric code can
    change without re-running models. It unpickles only files that its own
    `save` wrote."""

    def __init__(self, cache_dir: Optional[str]):
        self.cache_dir = cache_dir

    def _path(self, model_name, dataset_name):
        return os.path.join(self.cache_dir,
                            f"{model_name}__{dataset_name}__predictions.pkl")

    def load(self, model_name, dataset_name, query_order=None,
             target_order=None):
        if not self.cache_dir:
            return None
        path = self._path(model_name, dataset_name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if query_order is not None and \
                list(blob["query_order"]) != list(query_order):
            raise ValueError("cached query order mismatch")
        if target_order is not None and \
                list(blob["target_order"]) != list(target_order):
            raise ValueError("cached target order mismatch")
        return blob["predictions"]

    def save(self, model_name, dataset_name, predictions, query_order=None,
             target_order=None):
        if not self.cache_dir:
            return
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(self._path(model_name, dataset_name), "wb") as f:
            pickle.dump({"predictions": np.asarray(predictions),
                         "query_order": list(query_order or []),
                         "target_order": list(target_order or [])}, f)


def get_train_relations_for_eval(train_relations, query_order, target_order):
    """(query, target) pairs present in training -> set of (qi, ti) index
    pairs to NaN out of the eval label matrix."""
    qpos = {q: i for i, q in enumerate(query_order)}
    tpos = {t: i for i, t in enumerate(target_order)}
    leaks = set()
    for a, t in train_relations:
        if t in qpos and a in tpos:
            leaks.add((qpos[t], tpos[a]))
    return leaks
