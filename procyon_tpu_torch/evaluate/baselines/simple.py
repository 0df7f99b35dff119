"""kNN / MLP / random / score-matrix baselines (counterpart of
procyon_tpu/evaluate/baselines/simple.py), numpy only.

Equivalents of procyon/evaluate/framework/{knn,mlp,random,blast}.py: all run
on precomputed protein embeddings (esm2-650m/3b/esm3/gearnet) or on
precomputed pairwise score matrices (BLAST bit scores), no language model.
"""

from typing import Dict, Sequence, Tuple

import numpy as np

from procyon_tpu_torch.evaluate.qa import AbstractQAModel
from procyon_tpu_torch.evaluate.retrieval import AbstractRetrievalModel


def _normalize(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8)


class KNNRetrievalModel(AbstractRetrievalModel):
    """Label-matrix kNN (knn.py:43-196): a target protein's score for a
    query text is the similarity-weighted vote of the query's known positive
    training proteins."""

    name = "knn"

    def __init__(self, protein_embeddings: Dict[int, np.ndarray],
                 train_relations: Sequence[Tuple[int, int]], k: int = 10):
        self.embeds = protein_embeddings
        self.k = k
        self.pos_by_text: Dict[int, list] = {}
        for a, t in train_relations:
            self.pos_by_text.setdefault(t, []).append(a)

    def get_predictions(self, query_order, target_order, dataset=None):
        T = np.stack([self.embeds[t] for t in target_order])
        Tn = _normalize(T)
        scores = np.zeros((len(query_order), len(target_order)), np.float32)
        for qi, text_id in enumerate(query_order):
            pos = self.pos_by_text.get(text_id, [])
            if not pos:
                continue
            P = _normalize(np.stack([self.embeds[a] for a in pos]))
            sims = Tn @ P.T  # [T, P]
            k = min(self.k, sims.shape[1])
            topk = np.sort(sims, axis=1)[:, -k:]
            scores[qi] = topk.mean(axis=1)
        return scores


class KNNQAModel(AbstractQAModel):
    """kNN positive-control QA (knn.py + testing.py:640): yes-prob is the
    kNN retrieval score of (protein, text) rescaled to [0, 1]."""

    name = "knn"

    def __init__(self, protein_embeddings, train_relations, k=10):
        self.retrieval = KNNRetrievalModel(protein_embeddings,
                                           train_relations, k)

    def get_predictions(self, dataset):
        """dataset: sequence of (aaseq_idx, text_idx, label)."""
        aaseqs = sorted({a for a, _, _ in dataset})
        texts = sorted({t for _, t, _ in dataset})
        scores = self.retrieval.get_predictions(texts, aaseqs)
        lo, hi = scores.min(), scores.max()
        probs = (scores - lo) / max(hi - lo, 1e-8)
        t_pos = {t: i for i, t in enumerate(texts)}
        a_pos = {a: i for i, a in enumerate(aaseqs)}
        yes, labels = [], []
        for a, t, y in dataset:
            yes.append(probs[t_pos[t], a_pos[a]])
            labels.append(y)
        return np.asarray(yes), np.asarray(labels)


class MLPRetrievalModel(AbstractRetrievalModel):
    """Per-text MLP heads on frozen embeddings (mlp.py:55-392): one binary
    logistic head per query text, trained on its positive/negative training
    proteins."""

    name = "mlp"

    def __init__(self, protein_embeddings: Dict[int, np.ndarray],
                 train_relations: Sequence[Tuple[int, int]], *,
                 epochs: int = 50, lr: float = 0.1, l2: float = 1e-3,
                 neg_per_pos: int = 5, seed: int = 0):
        self.embeds = protein_embeddings
        self.train_by_text: Dict[int, list] = {}
        for a, t in train_relations:
            self.train_by_text.setdefault(t, []).append(a)
        self.epochs = epochs
        self.lr = lr
        self.l2 = l2
        self.neg_per_pos = neg_per_pos
        self.seed = seed

    def _fit_head(self, text_id, candidate_pool, rng):
        pos = self.train_by_text.get(text_id, [])
        if not pos:
            return None
        negs = rng.choice(candidate_pool,
                          min(len(candidate_pool),
                              self.neg_per_pos * len(pos)), replace=False)
        X = np.stack([self.embeds[a] for a in list(pos) + list(negs)])
        X = _normalize(X)
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(negs))])
        w = np.zeros(X.shape[1])
        b = 0.0
        for _ in range(self.epochs):
            z = X @ w + b
            p = 1 / (1 + np.exp(-z))
            g = p - y
            w -= self.lr * (X.T @ g / len(y) + self.l2 * w)
            b -= self.lr * g.mean()
        return w, b

    def get_predictions(self, query_order, target_order, dataset=None):
        rng = np.random.default_rng(self.seed)
        Tm = _normalize(np.stack([self.embeds[t] for t in target_order]))
        pool = np.asarray(list(self.embeds.keys()))
        scores = np.zeros((len(query_order), len(target_order)), np.float32)
        for qi, text_id in enumerate(query_order):
            head = self._fit_head(text_id, pool, rng)
            if head is None:
                continue
            w, b = head
            scores[qi] = Tm @ w + b
        return scores


class ScoreMatrixRetrievalModel(AbstractRetrievalModel):
    """Precomputed pairwise score matrix (BLAST bit scores, blast.py:26-88):
    a query text's score for target protein p is the max score between p and
    the query's known positive proteins."""

    name = "blast"

    def __init__(self, score_matrix: np.ndarray,
                 protein_index: Dict[int, int],
                 train_relations: Sequence[Tuple[int, int]]):
        self.S = score_matrix
        self.index = protein_index
        self.pos_by_text: Dict[int, list] = {}
        for a, t in train_relations:
            self.pos_by_text.setdefault(t, []).append(a)

    def get_predictions(self, query_order, target_order, dataset=None):
        tcols = np.asarray([self.index[t] for t in target_order])
        scores = np.zeros((len(query_order), len(target_order)), np.float32)
        for qi, text_id in enumerate(query_order):
            pos = [self.index[a] for a in self.pos_by_text.get(text_id, [])
                   if a in self.index]
            if not pos:
                continue
            scores[qi] = self.S[np.ix_(pos, tcols)].max(axis=0)
        return scores


class RandomRetrievalModel(AbstractRetrievalModel):
    name = "random"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def get_predictions(self, query_order, target_order, dataset=None):
        rng = np.random.default_rng(self.seed)
        return rng.random((len(query_order), len(target_order))).astype(
            np.float32)


class RandomQAModel(AbstractQAModel):
    name = "random"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def get_predictions(self, dataset):
        rng = np.random.default_rng(self.seed)
        labels = np.asarray([y for _, _, y in dataset])
        return rng.random(len(labels)), labels
