"""QA evaluation: yes / no accuracy, macro-F1 and a bootstrap CI
(counterpart of procyon_tpu/evaluate/qa.py), numpy only.

Models expose `get_predictions(dataset) -> (yes_probs, labels)`; the
probability of "yes" is read at the [ANSWER] position (`qa_yes_prob`). The
macro-F1 is `metrics.f1_macro`, scikit-learn's definition without
scikit-learn.
"""

from typing import Dict, Tuple

import numpy as np

from procyon_tpu_torch.evaluate.metrics import bootstrap_ci, f1_macro


class AbstractQAModel:
    name = "abstract"

    def get_predictions(self, dataset) -> Tuple[np.ndarray, np.ndarray]:
        """Return (yes_probs [N], labels [N] in {0, 1})."""
        raise NotImplementedError


def qa_yes_prob(logits_at_answer: np.ndarray, yes_id: int,
                no_id: int) -> np.ndarray:
    """P(yes | {yes, no}) from next-token logits at the [ANSWER]
    position."""
    yes = logits_at_answer[..., yes_id]
    no = logits_at_answer[..., no_id]
    m = np.maximum(yes, no)
    ey = np.exp(yes - m)
    en = np.exp(no - m)
    return ey / (ey + en)


def calc_qa_metrics(yes_probs: np.ndarray, labels: np.ndarray, *,
                    bootstrap: bool = True, n_boot: int = 200
                    ) -> Dict[str, float]:
    """Accuracy and macro-F1 of the predictions yes_probs >= 0.5, and the
    accuracy's bootstrap CI."""
    preds = (np.asarray(yes_probs) >= 0.5).astype(int)
    labels = np.asarray(labels, int)
    acc = float((preds == labels).mean()) if labels.size else float("nan")
    f1 = f1_macro(labels, preds) if labels.size else float("nan")
    out = {"accuracy": acc, "f1_macro": f1, "n": int(labels.size)}
    if bootstrap and labels.size:
        correct = (preds == labels).astype(float)
        _, lo, hi = bootstrap_ci(correct, n_boot=n_boot)
        out["accuracy_ci_low"] = lo
        out["accuracy_ci_high"] = hi
    return out


def run_qa_eval(model: AbstractQAModel, dataset, *, cache=None,
                dataset_name="dataset") -> Dict[str, float]:
    """The model's predictions (from `cache` when it holds them, which it
    then also keeps: `cache.load(name, key)` / `cache.save(name, key,
    array)`), then `calc_qa_metrics`."""
    cached = None
    if cache:
        try:
            cached = cache.load(model.name, f"{dataset_name}__qa")
        except ValueError:
            cached = None
    if cached is not None:
        yes_probs, labels = cached[:, 0], cached[:, 1]
    else:
        yes_probs, labels = model.get_predictions(dataset)
        if cache:
            cache.save(model.name, f"{dataset_name}__qa",
                       np.stack([yes_probs, labels], axis=1))
    return calc_qa_metrics(np.asarray(yes_probs), np.asarray(labels))
