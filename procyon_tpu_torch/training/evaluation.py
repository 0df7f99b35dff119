"""Mid-train held-out evaluation (counterpart of
procyon_tpu/training/evaluation.py; the reference's `_run_eval`,
procyon/training/trainIT.py:1556-1654).

Every eval_steps the trainer calls `eval_fn(params)`: the val-split
streams' QA / caption losses, and retrieval AUROC / AUPRC from the val
queries' cosine scores against every protein's shared-projector embedding
(frozen tables, or the live ESM encoder). The trainer's early stopping
watches the resulting "loss".

The model runs on the device its parameters are on, which must be of the
type `device` names ("cuda" unless the caller says otherwise); the scores
and metrics are numpy on the host.
"""

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from procyon_tpu_torch.bridge import tree_leaves
from procyon_tpu_torch.data.protein_tokenizer import (batch_encode,
                                                      bucket_protein_batch)
from procyon_tpu_torch.evaluate.metrics import per_query_auroc_auprc
from procyon_tpu_torch.models import unified
from procyon_tpu_torch.training import train_step as ts
from procyon_tpu_torch.training.prefetch import ready


def _params_device(params, device) -> torch.device:
    where = next(tree_leaves(params)).device
    if where.type != torch.device(device).type:
        raise ValueError(f"parameters on {where} but device={device}")
    return where


@torch.no_grad()
def all_protein_target_embeddings(params, cfg: unified.UnifiedConfig,
                                  store, protein_ids: Sequence[int], *,
                                  batch: int = 512,
                                  max_protein_len: int = 1024,
                                  device="cuda") -> np.ndarray:
    """[P, retrieval_dim] shared-projector embeddings for every protein id,
    f32 on the host (get_all_protein_embeddings, model_utils.py:44-96, and
    the trainer's eval sweep, trainIT.py:1594-1610)."""
    device = _params_device(params, device)
    out = []
    embed = unified.protein_embed_fn(cfg) if cfg.esm is not None else None
    for i in range(0, len(protein_ids), batch):
        chunk = protein_ids[i:i + batch]
        if cfg.esm is not None:
            # the JAX package pins the width and buckets the rows so that
            # its jitted sweep compiles once; the same shapes here give the
            # same embeddings
            pb = bucket_protein_batch(
                batch_encode([store.protein_sequence(a) for a in chunk],
                             max_len=max_protein_len),
                width=max_protein_len + 2)
            emb = embed(params, *(torch.from_numpy(x).to(device) for x in (
                pb.tokens, pb.group_ids, pb.row_valid)),
                pb.tokens.shape[0])[:pb.num_groups]
        else:
            raw = np.stack([store.protein_embedding(a) for a in chunk])
            emb = unified.target_protein_embeddings(
                params, cfg, torch.from_numpy(raw).to(device))
        out.append(emb.float().cpu().numpy())
    return np.concatenate(out, 0)


def build_midtrain_eval(cfg: unified.UnifiedConfig, *,
                        val_streams: Dict[str, Callable[[], Dict]],
                        store=None,
                        all_protein_ids: Optional[Sequence[int]] = None,
                        n_batches: int = 8,
                        to_device: Optional[Callable] = None,
                        protein_batch: int = 512,
                        device="cuda") -> Callable:
    """eval_fn(params) -> metrics over HELD-OUT streams.

    val_streams must be built from val/test-split datasets (DatasetEntry
    splits=["val"]), not the train streams. to_device turns a stream's
    batch into tensors on the device (train_step.batch_to_device by
    default; a prefetch.DeviceCopier's batches are made ready first).

    Per task:
      qa / caption: mean val loss / accuracy over n_batches
      retrieval: for each val batch, [PROT] query embeddings scored against
        the FULL protein target set (cosine); per-query AUROC/AUPRC with the
        batch's positive as the single label (trainIT.py:1626-1654), and
        retrieval/n_scored, the queries whose positive is among the
        targets: only those are scored, and with none AUROC / AUPRC and
        "loss" are NaN (the trainer then leaves its patience count alone;
        the reference reports no count)
    """
    if to_device is None:
        def to_device(b):
            return ts.batch_to_device(b, device)
    eval_steps = {t: ts.make_eval_step(cfg, t) for t in val_streams
                  if t != "retrieval"}

    def on_device(raw):
        return ready(to_device({k: v for k, v in raw.items()
                                if k != "reference_indices"}))

    def eval_fn(params) -> Dict[str, float]:
        _params_device(params, device)
        metrics: Dict[str, float] = {}
        for task, stream in val_streams.items():
            if task == "retrieval":
                continue
            sums: Dict[str, float] = {}
            for _ in range(n_batches):
                m = eval_steps[task](params, on_device(stream()))
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
            for k, v in sums.items():
                metrics[f"{task}/{k}"] = v / n_batches

        if "retrieval" in val_streams and store is not None and \
                all_protein_ids is not None:
            targets = all_protein_target_embeddings(
                params, cfg, store, all_protein_ids, batch=protein_batch,
                device=device)
            tn = targets / np.maximum(
                np.linalg.norm(targets, axis=1, keepdims=True), 1e-8)
            id_to_col = {a: i for i, a in enumerate(all_protein_ids)}
            aurocs, auprcs = [], []
            n_scored = 0
            for _ in range(n_batches):
                raw = val_streams["retrieval"]()
                pos_ids = raw["reference_indices"]["aaseq"]
                with torch.no_grad():
                    q = unified.retrieval_query_embedding(
                        params, cfg, on_device(raw)).float().cpu().numpy()
                qn = q / np.maximum(
                    np.linalg.norm(q, axis=1, keepdims=True), 1e-8)
                scores = qn @ tn.T                     # [B, P]
                labels = np.zeros_like(scores)
                for r, a in enumerate(pos_ids):
                    col = id_to_col.get(int(a))
                    if col is not None:
                        labels[r, col] = 1.0
                # per_query_auroc_auprc skips a row with one class only
                n_scored += int((labels.max(1) > labels.min(1)).sum())
                auroc, auprc = per_query_auroc_auprc(labels, scores)
                aurocs.append(auroc)
                auprcs.append(auprc)
            metrics["retrieval/auroc"] = float(np.nanmean(aurocs))
            metrics["retrieval/auprc"] = float(np.nanmean(auprcs))
            metrics["retrieval/n_scored"] = float(n_scored)

        # the trainer's early-stopping scalar: val losses summed
        # (retrieval contributes negated AUPRC so "lower is better" holds)
        loss_terms = [v for k, v in metrics.items() if k.endswith("/loss")]
        total = float(np.sum(loss_terms)) if loss_terms else 0.0
        if "retrieval/auprc" in metrics:
            total -= metrics["retrieval/auprc"]
        metrics["loss"] = total
        return metrics

    return eval_fn
