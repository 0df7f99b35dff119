"""Retrieval ranking (counterpart of get_proteins_from_embedding in
procyon_tpu/inference/prompts.py). numpy only."""

from typing import Optional, Sequence

import numpy as np


def get_proteins_from_embedding(all_protein_embeddings,
                                query_embedding, *,
                                protein_ids: Optional[Sequence] = None,
                                top_k: Optional[int] = 10):
    """Cosine top-k protein ranking. Returns a list of dicts (rank, protein
    id, score). Inputs are arrays or CPU tensors."""
    A = np.asarray(all_protein_embeddings, np.float32)
    q = np.asarray(query_embedding, np.float32).reshape(-1)
    An = A / np.maximum(np.linalg.norm(A, axis=1, keepdims=True), 1e-8)
    qn = q / max(np.linalg.norm(q), 1e-8)
    sims = An @ qn
    order = np.argsort(-sims)
    if top_k:
        order = order[:top_k]
    ids = protein_ids if protein_ids is not None else list(range(len(A)))
    return [{"rank": r + 1, "protein_id": ids[i], "score": float(sims[i])}
            for r, i in enumerate(order)]
