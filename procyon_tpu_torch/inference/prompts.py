"""Inference prompts (counterpart of procyon_tpu/inference/prompts.py).

Equivalent of procyon/data/inference_utils.py: create_input_retrieval
(:663-845), create_qa_input_simple (:247-421), create_caption_input_simple
(:67-245), batched merging (:847-919), and the embedding->ranked-protein
helpers (:921-999). These produce the same fixed-shape batches the collators
emit, from free-text user input instead of dataset rows.
"""

from typing import Dict, Optional, Sequence

import numpy as np

from procyon_tpu_torch.data import collators as C
from procyon_tpu_torch.data import instruct


class _InlineStore:
    """Store serving user-provided texts + protein data by index."""

    def __init__(self, base_store, extra_texts: Dict[int, str]):
        self.base = base_store
        self.extra = extra_texts

    def protein_sequence(self, idx):
        return self.base.protein_sequence(idx)

    def protein_embedding(self, idx):
        return self.base.protein_embedding(idx)

    def text(self, idx):
        if idx in self.extra:
            return self.extra[idx]
        return self.base.text(idx)


_USER_TEXT_BASE = 10 ** 9  # ids above this are inline user texts


def create_input_retrieval(task_desc_or_id, *, tokenizer, store,
                           task_library: Optional[instruct.TaskLibrary]
                           = None,
                           input_description: str = "",
                           drug_input: Optional[str] = None,
                           collator_cfg: Optional[C.CollatorConfig] = None,
                           num_examples: int = 1) -> Dict:
    """Build a retrieval query batch from a free-text description
    (create_input_retrieval, inference_utils.py:663-845)."""
    if not isinstance(input_description, str):
        raise TypeError(
            f"input_description must be one string, got "
            f"{type(input_description).__name__} (perturb_description "
            f"returns a LIST of variants — pass one of them)")
    lib = task_library or instruct.TaskLibrary()
    task = lib.get(task_desc_or_id) if isinstance(task_desc_or_id, str) \
        else task_desc_or_id
    prompt = instruct.get_prompt(task, num_examples=num_examples)
    text_id = _USER_TEXT_BASE
    istore = _InlineStore(store, {text_id: input_description})
    cfg = collator_cfg or C.CollatorConfig()
    coll = C.RetrievalCollator(cfg, tokenizer, istore, task)
    batch = coll([(0, text_id)], prompt)
    return batch


def create_qa_input_simple(task_desc_or_id, protein_idx: int, *, tokenizer,
                           store, input_description: str = "",
                           task_library=None, collator_cfg=None,
                           num_examples: int = 1) -> Dict:
    lib = task_library or instruct.TaskLibrary()
    task = lib.get(task_desc_or_id) if isinstance(task_desc_or_id, str) \
        else task_desc_or_id
    prompt = instruct.get_prompt(task, num_examples=num_examples)
    text_id = _USER_TEXT_BASE
    istore = _InlineStore(store, {text_id: input_description})
    cfg = collator_cfg or C.CollatorConfig()
    coll = C.QACollator(cfg, tokenizer, istore, task)
    return coll([(protein_idx, text_id, True)], prompt)


def create_caption_input_simple(task_desc_or_id, protein_idx: int, *,
                                tokenizer, store, task_library=None,
                                collator_cfg=None,
                                num_examples: int = 1) -> Dict:
    lib = task_library or instruct.TaskLibrary()
    task = lib.get(task_desc_or_id) if isinstance(task_desc_or_id, str) \
        else task_desc_or_id
    prompt = instruct.get_prompt(task, num_examples=num_examples)
    cfg = collator_cfg or C.CollatorConfig()
    coll = C.CaptionCollator(cfg, tokenizer, store, task)
    return coll([(protein_idx, 0)], prompt, for_generation=True)


def merge_model_input_dicts(batches: Sequence[Dict]) -> Dict:
    """Stack single-row batches into one batch
    (inference_utils.py:847-884). Protein banks are concatenated and
    soft_map/ret_target_pos re-offset."""
    out = {}
    offset = 0
    soft_maps, embeds, tpos = [], [], []
    for b in batches:
        sm = b["soft_map"].copy()
        sm[sm >= 0] += offset
        soft_maps.append(sm)
        if "protein_embeds" in b:
            embeds.append(b["protein_embeds"])
            n = b["protein_embeds"].shape[0]
        else:
            raise NotImplementedError("merge supports embedding mode")
        if "ret_target_pos" in b:
            tpos.append(b["ret_target_pos"] + offset)
        offset += n
    for k in batches[0]:
        if k in ("soft_map", "protein_embeds", "ret_target_pos",
                 "conflict_mask", "reference_indices"):
            continue
        if np.ndim(batches[0][k]) == 0:
            # a QA batch's yes_token / no_token: one value for all rows
            out[k] = batches[0][k]
            continue
        out[k] = np.concatenate([b[k] for b in batches], axis=0)
    out["soft_map"] = np.concatenate(soft_maps, 0)
    out["protein_embeds"] = np.concatenate(embeds, 0)
    if tpos:
        out["ret_target_pos"] = np.concatenate(tpos, 0)
    return out


def get_proteins_from_embedding(all_protein_embeddings: np.ndarray,
                                query_embedding: np.ndarray, *,
                                protein_ids: Optional[Sequence] = None,
                                top_k: Optional[int] = 10):
    """Cosine top-k protein ranking (inference_utils.py:921-977). Returns a
    list of dicts (rank, protein id, score) — DataFrame-compatible."""
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


def get_proteins_from_batched_embeddings(all_protein_embeddings,
                                         query_embeddings, *,
                                         protein_ids=None, top_k=10):
    return [get_proteins_from_embedding(all_protein_embeddings, q,
                                        protein_ids=protein_ids, top_k=top_k)
            for q in np.asarray(query_embeddings)]


def perturb_description(text: str, rng, *, drop_prob: float = 0.1,
                        shuffle: bool = False, n_variants: int = 5):
    """Description-perturbation variants for retrieval-robustness CIs
    (inference_utils.py:1001-1038): word dropout and optional sentence
    shuffling. Returns n_variants perturbed strings."""
    words = text.split()
    out = []
    for _ in range(n_variants):
        kept = [w for w in words if rng.random() > drop_prob] or words[:1]
        if shuffle:
            kept = list(kept)
            rng.shuffle(kept)
        out.append(" ".join(kept))
    return out


def retrieval_rank_stability(service, *, task_id: str, description: str,
                             k: int = 10, n_variants: int = 5, seed: int = 0,
                             drop_prob: float = 0.1):
    """Run retrieval on perturbed description variants and report how stable
    the top-k set is (mean Jaccard overlap with the unperturbed top-k)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = {r["protein_id"] for r in service.retrieve(
        task_id=task_id, disease_desc=description, k=k)}
    overlaps = []
    for variant in perturb_description(description, rng,
                                       drop_prob=drop_prob,
                                       n_variants=n_variants):
        got = {r["protein_id"] for r in service.retrieve(
            task_id=task_id, disease_desc=variant, k=k)}
        overlaps.append(len(base & got) / max(len(base | got), 1))
    return {"mean_jaccard": float(np.mean(overlaps)),
            "min_jaccard": float(np.min(overlaps)),
            "n_variants": n_variants}


def perturbation_confidence(description: str, query_fn, *,
                            n_perturbations: int = 10,
                            drop_prob: float = 0.1, seed=None):
    """Run query_fn on word-dropout variants of a description and collect
    per-variant outputs plus score statistics (inference_utils.py:1019-1038
    desc_perturbation): the per-target mean/std/quantiles over variants give
    retrieval confidence intervals.

    query_fn(desc) -> 1D score array over targets (or any object; stats are
    computed only when outputs are numeric arrays of equal shape)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    variants = perturb_description(description, rng, drop_prob=drop_prob,
                                   n_variants=n_perturbations)
    outputs = {f"perturb_{i}": query_fn(v)
               for i, v in enumerate(variants)}
    result = {"outputs": outputs, "variants": variants}
    vals = list(outputs.values())
    try:
        arr = np.stack([np.asarray(v, np.float64) for v in vals])
    except Exception:
        return result
    if arr.ndim >= 1 and np.issubdtype(arr.dtype, np.number):
        result["stats"] = {
            "mean": arr.mean(0),
            "std": arr.std(0),
            "q05": np.quantile(arr, 0.05, axis=0),
            "q95": np.quantile(arr, 0.95, axis=0),
        }
    return result
