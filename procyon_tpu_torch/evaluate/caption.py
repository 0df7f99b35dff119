"""Caption evaluation: the model interface (counterpart of
procyon_tpu/evaluate/caption.py).

Only the base class is ported: the caption metrics (ROUGE-L, BLEU,
BERTScore) and `run_caption_eval` wait for the evaluation slice
(ROADMAP.md, queue 1).
"""

from typing import Dict


class AbstractCaptionModel:
    name = "abstract"

    def get_predictions(self, dataset) -> Dict[int, str]:
        """Return {entity_id: generated caption}."""
        raise NotImplementedError
