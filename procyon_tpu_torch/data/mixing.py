"""Multi-dataset task mixing with deterministic, resumable iteration (a
copy of procyon_tpu/data/mixing.py: host numpy).

Equivalent of MetaDataset/MetaCollator (procyon/data/metadataset.py:6-90)
plus DistributedSamplerResume (procyon/data/samplers.py:17-152): each
sub-dataset is pre-chunked into batches; the mixed stream interleaves
(dataset_key, batch_indices) items; iteration is a pure function of
(seed, epoch) so exact mid-epoch resume is replaying the shuffle and
skipping consumed items; per-host sharding takes rank-interleaved items
(indices[rank::world]).
"""

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MixerState:
    epoch: int = 0
    index: int = 0  # items consumed within the epoch (global, pre-shard)

    def to_dict(self):
        return {"epoch": self.epoch, "index": self.index}

    @classmethod
    def from_dict(cls, d):
        return cls(epoch=int(d["epoch"]), index=int(d["index"]))


class TaskMixer:
    """Deterministic interleaved batch stream over named datasets."""

    def __init__(self, datasets: Dict[str, "object"],
                 batch_sizes: Dict[str, int], *, seed: int = 0,
                 rank: int = 0, world_size: int = 1,
                 weights: Optional[Dict[str, float]] = None):
        self.datasets = datasets
        self.batch_sizes = batch_sizes
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.weights = weights or {}

    def _epoch_items(self, epoch: int) -> List[Tuple[str, np.ndarray]]:
        """All (dataset_key, batch_indices) items for an epoch, shuffled."""
        rng = np.random.default_rng((self.seed, epoch))
        items: List[Tuple[str, np.ndarray]] = []
        for key, ds in self.datasets.items():
            n = len(ds)
            order = rng.permutation(n)
            repeat = self.weights.get(key, 1.0)
            reps = int(repeat)
            frac = repeat - reps
            full_order = [order] * reps
            if frac > 0:
                full_order.append(order[: int(n * frac)])
            order = np.concatenate(full_order) if full_order else order
            bs = self.batch_sizes[key]
            for i in range(0, len(order) - bs + 1, bs):
                items.append((key, order[i:i + bs]))
        perm = rng.permutation(len(items))
        return [items[i] for i in perm]

    def epoch_length(self, epoch: int = 0) -> int:
        return len(self._epoch_items(epoch))

    def iterate(self, state: MixerState) -> Iterator[
            Tuple[str, np.ndarray, MixerState]]:
        """Yields (dataset_key, indices, next_state). Resumable: pass the
        last yielded state to continue exactly after it."""
        epoch = state.epoch
        index = state.index
        while True:
            items = self._epoch_items(epoch)
            while index < len(items):
                if index % self.world_size == self.rank:
                    key, idxs = items[index]
                    yield key, idxs, MixerState(epoch, index + 1)
                index += 1
            epoch += 1
            index = 0


class SequentialShardSampler:
    """Contiguous per-rank chunks so gathered eval outputs concatenate in
    order (SequentialDistributedSampler, samplers.py:154-199)."""

    def __init__(self, n: int, rank: int, world_size: int,
                 batch_size: int = 1):
        per_rank = -(-n // world_size)
        self.start = rank * per_rank
        self.end = min(self.start + per_rank, n)
        self.total = per_rank * world_size
        self.batch_size = batch_size

    def __iter__(self):
        return iter(range(self.start, self.end))

    def batches(self):
        idxs = list(range(self.start, self.end))
        for i in range(0, len(idxs), self.batch_size):
            yield idxs[i:i + self.batch_size]
