"""Budget-proportional dataset sampling tracker (a copy of
procyon_tpu/data/dataset_tracker.py).

Equivalent of procyon/training/dataset_tracker.py (:1-79): tracks a
per-dataset sample budget, samples datasets proportionally to remaining
budget, handles world-size transitions, and serializes its state for
resume. (The reference wired it up then commented it out of the trainer,
trainIT.py:1827-1839; here it plugs into TaskMixer via `weights`.)
"""

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DatasetTracker:
    budgets: Dict[str, int]                  # total samples per dataset
    consumed: Dict[str, int] = dataclasses.field(default_factory=dict)
    world_size: int = 1

    def __post_init__(self):
        for k in self.budgets:
            self.consumed.setdefault(k, 0)

    def remaining(self, key: str) -> int:
        return max(self.budgets[key] - self.consumed[key], 0)

    def probabilities(self) -> Dict[str, float]:
        rem = {k: self.remaining(k) for k in self.budgets}
        total = sum(rem.values())
        if total == 0:
            n = len(self.budgets)
            return {k: 1.0 / n for k in self.budgets}
        return {k: v / total for k, v in rem.items()}

    def sample(self, rng: np.random.Generator) -> Optional[str]:
        probs = self.probabilities()
        keys = sorted(probs)
        p = np.asarray([probs[k] for k in keys])
        if p.sum() == 0:
            return None
        return keys[int(rng.choice(len(keys), p=p / p.sum()))]

    def record(self, key: str, n: int):
        """Record n consumed samples (counted once per global batch; each
        rank contributes n/world_size locally)."""
        self.consumed[key] += n

    def rescale_world_size(self, new_world_size: int):
        """World-size transition (reference world-size logic): budgets are
        global, so consumption accounting is unchanged; only the per-rank
        contribution factor moves."""
        self.world_size = new_world_size

    def exhausted(self) -> bool:
        return all(self.remaining(k) == 0 for k in self.budgets)

    def to_dict(self):
        return {"budgets": dict(self.budgets),
                "consumed": dict(self.consumed),
                "world_size": self.world_size}

    @classmethod
    def from_dict(cls, d):
        return cls(budgets=dict(d["budgets"]),
                   consumed=dict(d["consumed"]),
                   world_size=int(d.get("world_size", 1)))
