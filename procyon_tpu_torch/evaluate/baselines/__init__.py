"""Comparison baseline models (counterpart of
procyon_tpu/evaluate/baselines): kNN, the per-text MLP, the score matrix
(BLAST) and random over precomputed embeddings (numpy, simple.py); the
third-party text-encoder baselines BioTranslator, ProtST and the
PubMedBERT / SimCSE towers (text_models.py); and the ProtLLM QA baseline
(protllm.py).
"""

from procyon_tpu_torch.evaluate.baselines.simple import (
    KNNQAModel, KNNRetrievalModel, MLPRetrievalModel, RandomQAModel,
    RandomRetrievalModel, ScoreMatrixRetrievalModel,
)

from procyon_tpu_torch.evaluate.baselines.protllm import ProtLLMQAEval
from procyon_tpu_torch.evaluate.baselines.text_models import (
    BertTextTower, BioTranslatorRetrievalEval, CNNConfig,
    ProtSTRetrievalEval, TextEncoderRetrievalEval,
)

__all__ = ["KNNRetrievalModel", "KNNQAModel", "MLPRetrievalModel",
           "RandomRetrievalModel", "RandomQAModel",
           "ScoreMatrixRetrievalModel", "BertTextTower", "CNNConfig",
           "BioTranslatorRetrievalEval", "ProtSTRetrievalEval",
           "TextEncoderRetrievalEval", "ProtLLMQAEval"]
