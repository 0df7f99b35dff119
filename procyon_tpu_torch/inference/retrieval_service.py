"""Retrieval service helpers (counterpart of
procyon_tpu/inference/retrieval_service.py).

`startup_retrieval` embeds every protein through the shared projector
(cached as a pickle when a path is given); `RetrievalService.retrieve`
builds a retrieval query from a task id and a description, runs the model
and returns ranked proteins. The model runs on an explicit `device`
("cuda" unless the caller says otherwise); the ranking is numpy on the
host.
"""

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from procyon_tpu_torch.data import collators as C
from procyon_tpu_torch.data import instruct
from procyon_tpu_torch.inference import prompts
from procyon_tpu_torch.models import unified


def _check_device(params, device) -> torch.device:
    """`device`, after checking that the parameters live on a device of
    that type: the service never moves a model, and never falls to the
    CPU unasked."""
    device = torch.device(device)
    where = params["llama"]["embed"].device
    if where.type != device.type:
        raise ValueError(f"parameters on {where} but device={device}")
    return where


@dataclasses.dataclass
class RetrievalService:
    params: dict
    cfg: unified.UnifiedConfig
    tokenizer: object
    store: object
    all_protein_embeddings: np.ndarray  # shared-projector space [N, D]
    protein_ids: Sequence
    device: torch.device
    task_library: instruct.TaskLibrary = dataclasses.field(
        default_factory=instruct.TaskLibrary)

    def query_batch(self, *, task_id: str, disease_desc: str) -> Dict:
        """The model batch of one description, as tensors on the device."""
        batch = prompts.create_input_retrieval(
            task_id, tokenizer=self.tokenizer, store=self.store,
            task_library=self.task_library,
            input_description=disease_desc,
            collator_cfg=C.CollatorConfig(
                protein_embed_dim=self.cfg.encoder_out_dim))
        return {key: torch.from_numpy(np.asarray(v)).to(self.device)
                for key, v in batch.items() if key != "reference_indices"}

    @torch.no_grad()
    def retrieve(self, *, task_id: str, disease_desc: str,
                 instruction_source_dataset: Optional[str] = None,
                 k: int = 10) -> List[Dict]:
        """Description -> ranked proteins."""
        if instruction_source_dataset and not task_id:
            task_id = f"{instruction_source_dataset}_all_retrieval"
        q = unified.retrieval_query_embedding(
            self.params, self.cfg,
            self.query_batch(task_id=task_id, disease_desc=disease_desc))
        return prompts.get_proteins_from_embedding(
            self.all_protein_embeddings, q[0].float().cpu().numpy(),
            protein_ids=self.protein_ids, top_k=k)


@torch.no_grad()
def build_all_protein_embeddings(params, cfg, store, protein_ids, *,
                                 device="cuda",
                                 cache_path: Optional[str] = None,
                                 batch_size: int = 256) -> np.ndarray:
    """Embed every protein through the shared projector, cached as a pickle
    of {"ids", "embeds"} that this function wrote."""
    device = _check_device(params, device)
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            blob = pickle.load(f)
        if list(blob["ids"]) == list(protein_ids):
            return blob["embeds"]
    chunks = []
    for i in range(0, len(protein_ids), batch_size):
        ids = protein_ids[i:i + batch_size]
        raw = np.stack([store.protein_embedding(p) for p in ids])
        emb = unified.target_protein_embeddings(
            params, cfg, torch.from_numpy(raw).to(device))
        chunks.append(emb.float().cpu().numpy())
    embeds = np.concatenate(chunks, 0)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump({"ids": list(protein_ids), "embeds": embeds}, f)
    return embeds


def startup_retrieval(params, cfg, tokenizer, store, protein_ids, *,
                      device="cuda",
                      cache_path: Optional[str] = None) -> RetrievalService:
    device = _check_device(params, device)
    embeds = build_all_protein_embeddings(params, cfg, store, protein_ids,
                                          device=device,
                                          cache_path=cache_path)
    return RetrievalService(params=params, cfg=cfg, tokenizer=tokenizer,
                            store=store, all_protein_embeddings=embeds,
                            protein_ids=protein_ids, device=device)
