"""ProCyon model wrappers for the eval framework (counterpart of
procyon_tpu/evaluate/procyon_models.py).

Only `ProcyonCaptionEval` (diverse-beam generation) is ported; the
retrieval and QA wrappers wait for the evaluation slice (ROADMAP.md,
queue 1).
"""

from typing import Dict, Optional

import torch

from procyon_tpu_torch.data import collators as C
from procyon_tpu_torch.data import instruct
from procyon_tpu_torch.evaluate.caption import AbstractCaptionModel
from procyon_tpu_torch.inference import generation, paged_beam
from procyon_tpu_torch.models import unified


class ProcyonCaptionEval(AbstractCaptionModel):
    name = "procyon"

    def __init__(self, params, cfg: unified.UnifiedConfig, tokenizer, store,
                 task, *, batch_size: int = 8,
                 gen: Optional[generation.GenerationConfig] = None,
                 collator_cfg=None, use_paged: bool = False,
                 page_size: int = 64, shared_prefix: bool = False,
                 device="cuda"):
        where = params["llama"]["embed"].device
        if where.type != torch.device(device).type:
            raise ValueError(f"parameters on {where} but device={device}")
        self.device = where
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
