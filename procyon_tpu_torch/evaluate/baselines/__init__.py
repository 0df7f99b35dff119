"""Comparison baseline models over precomputed embeddings (counterpart of
procyon_tpu/evaluate/baselines): kNN, the per-text MLP, the score matrix
(BLAST) and random, all numpy, no language model. The text-encoder and
ProtLLM baselines wait for Slice 6b (ROADMAP.md, queue 1).
"""

from procyon_tpu_torch.evaluate.baselines.simple import (
    KNNQAModel, KNNRetrievalModel, MLPRetrievalModel, RandomQAModel,
    RandomRetrievalModel, ScoreMatrixRetrievalModel,
)

__all__ = ["KNNRetrievalModel", "KNNQAModel", "MLPRetrievalModel",
           "RandomRetrievalModel", "RandomQAModel",
           "ScoreMatrixRetrievalModel"]
