"""ProCyon model wrappers for the eval framework (counterpart of
procyon_tpu/evaluate/procyon_models.py):
  * ProcyonRetrievalEval: query embeddings from the [PROT] hidden state,
    target embeddings through the protein-only path (with an on-disk
    cache), the cosine matrix
  * ProcyonQAEval: the yes / no probability at [ANSWER], in the decoder's
    `quant_mode` (a Bind model scores in W8A8)
  * ProcyonCaptionEval: diverse-beam generation

Each runs on the device its parameters are on, which must be of the type
`device` names ("cuda" unless the caller says otherwise); none moves a
model or falls back to the CPU.
"""

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from procyon_tpu_torch.data import collators as C
from procyon_tpu_torch.data import instruct
from procyon_tpu_torch.evaluate.caption import AbstractCaptionModel
from procyon_tpu_torch.evaluate.qa import AbstractQAModel, qa_yes_prob
from procyon_tpu_torch.evaluate.retrieval import AbstractRetrievalModel
from procyon_tpu_torch.inference import generation, paged_beam
from procyon_tpu_torch.models import unified
from procyon_tpu_torch.training.evaluation import (
    _params_device, all_protein_target_embeddings)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-8)


class ProcyonRetrievalEval(AbstractRetrievalModel):
    name = "procyon"

    def __init__(self, params, cfg: unified.UnifiedConfig, tokenizer, store,
                 task: Dict, *, batch_size: int = 16,
                 target_cache_path: Optional[str] = None,
                 collator_cfg: Optional[C.CollatorConfig] = None,
                 device="cuda"):
        self.device = _params_device(params, device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.store = store
        self.task = task
        self.batch_size = batch_size
        self.target_cache_path = target_cache_path
        self.ccfg = collator_cfg or C.CollatorConfig(
            protein_embed_dim=cfg.encoder_out_dim)
        self.prompt = instruct.get_prompt(task, num_examples=1)
        self.collator = C.RetrievalCollator(self.ccfg, tokenizer, store, task)

    @torch.no_grad()
    def query_embeddings(self, query_order) -> torch.Tensor:
        """[Q, retrieval_dim] f32 query embeddings on the device, in
        batches of batch_size."""
        out = []
        for i in range(0, len(query_order), self.batch_size):
            # the target protein of each sample is unused
            batch = self.collator([(0, t) for t in
                                   query_order[i:i + self.batch_size]],
                                  self.prompt)
            emb = unified.retrieval_query_embedding(
                self.params, self.cfg,
                paged_beam.to_device(batch, self.device))
            out.append(emb.float())
        return torch.cat(out, 0)

    def target_embeddings(self, target_order) -> np.ndarray:
        """Protein-side shared-projector embeddings [T, retrieval_dim], f32
        on the host (frozen tables, or the live ESM2 at the collator's
        max_protein_len), cached on disk as a pickle of {"order", "embeds"}
        (kept only when its order is target_order)."""
        if self.target_cache_path and os.path.exists(self.target_cache_path):
            with open(self.target_cache_path, "rb") as f:
                blob = pickle.load(f)
            if list(blob["order"]) == list(target_order):
                return blob["embeds"]
        embeds = all_protein_target_embeddings(
            self.params, self.cfg, self.store, target_order, batch=256,
            max_protein_len=self.ccfg.max_protein_len, device=self.device)
        if self.target_cache_path:
            os.makedirs(os.path.dirname(self.target_cache_path) or ".",
                        exist_ok=True)
            with open(self.target_cache_path, "wb") as f:
                pickle.dump({"order": list(target_order), "embeds": embeds},
                            f)
        return embeds

    @torch.no_grad()
    def get_predictions(self, query_order, target_order, dataset=None):
        """The [Q, T] cosine matrix, in f32 on the device, as numpy."""
        q = self.query_embeddings(query_order)
        t = torch.from_numpy(self.target_embeddings(target_order)).to(
            self.device)
        return (_unit_rows(q) @ _unit_rows(t).T).cpu().numpy()


class ProcyonQAEval(AbstractQAModel):
    name = "procyon"

    def __init__(self, params, cfg: unified.UnifiedConfig, tokenizer, store,
                 task, *, batch_size: int = 16, collator_cfg=None,
                 device="cuda"):
        self.device = _params_device(params, device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        ccfg = collator_cfg or C.CollatorConfig(
            protein_embed_dim=cfg.encoder_out_dim)
        self.prompt = instruct.get_prompt(task, num_examples=1)
        self.collator = C.QACollator(ccfg, tokenizer, store, task)

    def answer_logits(self, chunk) -> np.ndarray:
        """One batch of (aaseq_idx, text_idx, label): the logits [n, vocab]
        at each prompt's [ANSWER] position, f32 on the host."""
        batch = self.collator([(a, t, bool(y)) for a, t, y in chunk],
                              self.prompt)
        with torch.no_grad():
            out = unified.forward(self.params, self.cfg,
                                  paged_beam.to_device(batch, self.device))
            rows = torch.arange(len(chunk), device=self.device)
            ans = torch.as_tensor(np.asarray(batch["answer_pos"]),
                                  device=self.device).long()
            return out["logits"][rows, ans].float().cpu().numpy()

    def get_predictions(self, dataset):
        """dataset: sequence of (aaseq_idx, text_idx, label). Returns
        (yes_probs [N], labels [N])."""
        yes_all, labels_all = [], []
        spec = self.tokenizer.spec
        for i in range(0, len(dataset), self.batch_size):
            chunk = dataset[i:i + self.batch_size]
            yes_all.append(qa_yes_prob(self.answer_logits(chunk),
                                       spec.yes_id, spec.no_id))
            labels_all.append([y for _, _, y in chunk])
        return np.concatenate(yes_all), np.concatenate(labels_all)


class ProcyonCaptionEval(AbstractCaptionModel):
    name = "procyon"

    def __init__(self, params, cfg: unified.UnifiedConfig, tokenizer, store,
                 task, *, batch_size: int = 8,
                 gen: Optional[generation.GenerationConfig] = None,
                 collator_cfg=None, use_paged: bool = False,
                 page_size: int = 64, shared_prefix: bool = False,
                 device="cuda"):
        self.device = _params_device(params, device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.gen = gen or generation.GenerationConfig(
            max_new_tokens=200, method="beam", beam_size=10,
            beam_group_size=2, diversity_penalty=0.8,
            eos_token_id=tokenizer.spec.eos_id,
            pad_token_id=tokenizer.spec.pad_id)
        # paged beam decode (inference/paged_beam.py): beams share the
        # prompt's KV pages; identical tokens to the dense path.
        # shared_prefix additionally dedups identical leading prompt
        # blocks (one instruction template per caption batch), within a
        # batch and, via a persistent BeamPoolSession, across batches:
        # chunks 2..n hit the cached instruction KV (prefill skipped)
        self.use_paged = use_paged
        self.page_size = page_size
        self.shared_prefix = shared_prefix
        self._session = None
        ccfg = collator_cfg or C.CollatorConfig(
            protein_embed_dim=cfg.encoder_out_dim)
        self.prompt = instruct.get_prompt(task, num_examples=1)
        self.collator = C.CaptionCollator(ccfg, tokenizer, store, task)

    @property
    def session(self):
        """The BeamPoolSession of the paged shared-prefix route (None until
        its first batch)."""
        return self._session

    def get_predictions(self, dataset) -> Dict[int, str]:
        """dataset: sequence of aaseq indices to caption."""
        out: Dict[int, str] = {}
        beam = self.gen.method == "beam"
        for i in range(0, len(dataset), self.batch_size):
            chunk = list(dataset[i:i + self.batch_size])
            samples = [(a, 0) for a in chunk]
            if beam and self.use_paged and self.shared_prefix:
                # pad the ragged last chunk so every batch matches the
                # session's fixed pool shape (pad captions are discarded;
                # the repeated row is a full cache hit)
                while len(samples) < self.batch_size:
                    samples.append(samples[-1])
            batch = self.collator(samples, self.prompt, for_generation=True)
            if beam and self.use_paged:
                if self.shared_prefix and self._session is None:
                    self._session = paged_beam.BeamPoolSession(
                        page_size=self.page_size)
                tokens, _ = paged_beam.paged_beam_generate(
                    self.params, self.cfg, batch, self.gen,
                    page_size=self.page_size,
                    shared_prefix=self.shared_prefix,
                    session=self._session)
                tokens = tokens[:len(chunk), 0]
            elif beam:
                tokens, _ = generation.generate_beam(
                    self.params, self.cfg,
                    paged_beam.to_device(batch, self.device), self.gen)
                tokens = tokens[:, 0]  # best hypothesis
            else:
                tokens = generation.generate(
                    self.params, self.cfg,
                    paged_beam.to_device(batch, self.device), self.gen)
            for a, toks in zip(chunk, tokens.cpu().numpy()):
                out[a] = self.tokenizer.decode(toks)
        return out
