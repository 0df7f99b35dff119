"""QA readout (counterpart of qa_yes_prob in procyon_tpu/evaluate/qa.py).
numpy only. The QA model wrappers and metrics are not ported yet
(ROADMAP.md, queue 1, the evaluate slice)."""

import numpy as np


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
