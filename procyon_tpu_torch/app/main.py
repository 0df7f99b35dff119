"""Retrieval service construction and the optional FastAPI app
(counterpart of procyon_tpu/app/main.py).

POST /retrieve takes task_desc / disease_desc / instruction_source_dataset
in {disgenet, omim} / k and returns the top-k protein records.

`_build_service` with PROCYON_SYNTHETIC=1 builds a synthetic service at
ProCyon-Full widths (Llama-3-8B, frozen 2560-wide protein embeddings, a
3-layer 2560-hidden token projector, retrieval_dim 1024) from seeded random
weights on the device.
Loading a trained checkpoint waits for a checkpoint in a torch-readable
format (ROADMAP.md, queue 1).

Run: `uvicorn procyon_tpu_torch.app.main:app --port 8000` where fastapi is
installed, else `python -m procyon_tpu_torch.app.server`.
"""

import os
from typing import Optional

try:
    from fastapi import FastAPI, HTTPException
    from pydantic import BaseModel
except ImportError:  # fastapi is optional
    FastAPI = None

from procyon_tpu_torch.inference.retrieval_service import (RetrievalService,
                                                           startup_retrieval)

_service: Optional[RetrievalService] = None

SYNTHETIC_PROTEINS = 20000
SYNTHETIC_SEED = 0


def procyon_full_config(n_layers: Optional[int] = None):
    """ProCyon-Full (configs/llama3-full.yml as the reference's config.py
    reads it): Llama-3-8B in bf16, frozen-embedding mode, a 3-layer
    2560-hidden token projector, 1-layer retrieval projectors."""
    import torch

    from procyon_tpu_torch.models import llama, unified

    kw = {} if n_layers is None else {"n_layers": n_layers}
    return unified.UnifiedConfig(
        llama=llama.llama3_8b(dtype=torch.bfloat16, **kw), esm=None,
        protein_embed_dim=2560, token_projector_layers=3,
        token_projector_hidden=2560, retrieval_dim=1024,
        retrieval_projector_layers=1, dtype=torch.bfloat16)


def _build_service(device="cuda") -> RetrievalService:
    from procyon_tpu_torch.data import datasets
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.models import unified

    if os.environ.get("PROCYON_SYNTHETIC"):
        cfg = procyon_full_config()
        params = unified.init_params(SYNTHETIC_SEED, cfg, device=device)
        store = datasets.SyntheticStore(n_proteins=SYNTHETIC_PROTEINS,
                                        embed_dim=cfg.protein_embed_dim)
        tokenizer = load_tokenizer(vocab_size=cfg.llama.vocab_size)
        ids = list(range(store.n_proteins))
        return startup_retrieval(params, cfg, tokenizer, store, ids,
                                 device=device)
    raise RuntimeError(
        "set PROCYON_SYNTHETIC=1: loading a checkpoint is not ported to "
        "procyon_tpu_torch yet (ROADMAP.md, queue 1, checkpoint_io)")


if FastAPI is not None:
    app = FastAPI(title="procyon-tpu-torch retrieval")

    class RetrieveRequest(BaseModel):
        task_desc: str = ""
        disease_desc: str
        instruction_source_dataset: str = "disgenet"
        k: int = 10

    @app.on_event("startup")
    def _startup():
        global _service
        _service = _build_service()

    @app.post("/retrieve")
    def retrieve(req: RetrieveRequest):
        if _service is None:
            raise HTTPException(503, "service not initialized")
        if req.instruction_source_dataset not in ("disgenet", "omim"):
            raise HTTPException(
                422, "instruction_source_dataset must be disgenet or omim")
        task_id = f"{req.instruction_source_dataset}_all_retrieval"
        results = _service.retrieve(task_id=task_id,
                                    disease_desc=req.disease_desc,
                                    k=req.k)
        return {"results": results}

    @app.get("/healthz")
    def healthz():
        return {"ok": _service is not None}
