"""Caption evaluation: ROUGE-L / BLEU against merged references
(counterpart of procyon_tpu/evaluate/caption.py), host code only.

Per-protein generated captions are scored against ALL reference
descriptions for that protein (multi-reference merge). BERTScore, the
reference's optional third metric, needs models/bert.py and
evaluate/bertscore.py, which are not ported: asking for it raises.
"""

from typing import Dict, List, Sequence

import numpy as np

from procyon_tpu_torch.evaluate.metrics import bleu, bootstrap_ci, rouge_l

BERTSCORE_NOT_PORTED = (
    "BERTScore needs models/bert.py and evaluate/bertscore.py, which are not "
    "ported to procyon_tpu_torch yet (ROADMAP.md, queue 1: \"Slice 6b: "
    "BERT, BERTScore and the text baselines\")")


class AbstractCaptionModel:
    name = "abstract"

    def get_predictions(self, dataset) -> Dict[int, str]:
        """Return {entity_id: generated caption}."""
        raise NotImplementedError


def merge_references(relations: Sequence) -> Dict[int, List[str]]:
    """(entity_id, reference_text) pairs -> {entity_id: [refs...]}."""
    refs: Dict[int, List[str]] = {}
    for ent, text in relations:
        refs.setdefault(ent, []).append(text)
    return refs


def calc_caption_metrics(predictions: Dict[int, str],
                         references: Dict[int, List[str]], *,
                         use_bertscore: bool = False,
                         bertscorer=None,
                         bootstrap: bool = True,
                         n_boot: int = 200) -> Dict[str, float]:
    if use_bertscore or bertscorer is not None:
        raise NotImplementedError(BERTSCORE_NOT_PORTED)
    rouges, bleus = [], []
    for ent, hyp in predictions.items():
        refs = references.get(ent)
        if not refs:
            continue
        rouges.append(rouge_l(hyp, refs))
        bleus.append(bleu(hyp, refs))
    out = {
        "rouge_l": float(np.mean(rouges)) if rouges else float("nan"),
        "bleu": float(np.mean(bleus)) if bleus else float("nan"),
        "n": len(rouges),
    }
    if bootstrap and rouges:
        _, lo, hi = bootstrap_ci(np.asarray(rouges), n_boot=n_boot)
        out["rouge_l_ci_low"] = lo
        out["rouge_l_ci_high"] = hi
    return out


def run_caption_eval(model: AbstractCaptionModel, dataset, *,
                     references: Dict[int, List[str]],
                     use_bertscore: bool = False,
                     bertscorer=None,
                     dataset_name="dataset") -> Dict[str, float]:
    # refuse before the model generates, not after
    if use_bertscore or bertscorer is not None:
        raise NotImplementedError(BERTSCORE_NOT_PORTED)
    predictions = model.get_predictions(dataset)
    return calc_caption_metrics(predictions, references)
