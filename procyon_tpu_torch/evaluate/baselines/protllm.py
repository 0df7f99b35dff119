"""ProtLLM-style QA baseline (counterpart of
procyon_tpu/evaluate/baselines/protllm.py).

The reference's ProtLLM QA baseline
(procyon/evaluate/framework/ProtLLMQA.py:365-835, procyon/model/protllm.py)
is an ESM-2-650M protein encoder whose mean-pooled embedding is projected
linearly (`prot2llm_linear`) into a Llama decoder's token space and
spliced into the prompt where the protein is named; a binary head reads the
first token of each label word ("yes" / "no") at the last position
(protllm.py:243-320, ProtLlmForBinaryCls). Here: the port's ESM2
(models/esm2.py) and Llama (models/llama.py: the flash forward kernel,
causal, on the card), one projector matrix, and the softmax over the two
label tokens' logits at the last prompt position. The models run on their
parameters' device; the yes-probabilities come back as numpy.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from procyon_tpu_torch.evaluate.qa import AbstractQAModel
from procyon_tpu_torch.models._init import make_generator
from procyon_tpu_torch.ops import quant


@dataclasses.dataclass
class ProtLLMConfig:
    max_text_len: int = 128
    max_protein_len: int = 256
    batch_size: int = 8


class ProtLLMQAEval(AbstractQAModel):
    name = "protllm"

    def __init__(self, esm_params, esm_cfg, llama_params, llama_cfg,
                 projector, tokenizer, store, *,
                 cfg: Optional[ProtLLMConfig] = None,
                 prompt_template: str =
                 "Does the protein <|protein|> have the following "
                 "property? [EXT] Answer: "):
        self.esm_params = esm_params
        self.esm_cfg = esm_cfg
        self.llama_params = llama_params
        self.llama_cfg = llama_cfg
        self.projector = projector  # [esm_dim, llama_dim]
        self.tokenizer = tokenizer
        self.store = store
        self.cfg = cfg or ProtLLMConfig()
        self.prompt_template = prompt_template

    @classmethod
    def synthetic(cls, store, *, seed: int = 0, device="cuda", **kw):
        """The tiny ESM2 and Llama (f32 on the CPU, bf16 elsewhere: the
        attention kernels' type), a projector N(0, 1 / esm_dim), the word
        tokenizer; seeded."""
        from procyon_tpu_torch.data.text_tokenizer import WordTokenizer
        from procyon_tpu_torch.models import esm2, llama

        device = torch.device(device)
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
        g, _ = make_generator(seed, device)
        ecfg = esm2.tiny_config(dtype=dtype)
        lcfg = llama.tiny_config(dtype=dtype)
        eparams = esm2.init_params(g, ecfg, device=device)
        lparams = llama.init_params(g, lcfg, device=device)
        proj = torch.randn((ecfg.dim, lcfg.dim), generator=g, device=device,
                           dtype=torch.float32) / ecfg.dim ** 0.5
        return cls(eparams, ecfg, lparams, lcfg, proj,
                   WordTokenizer(vocab_size=lcfg.vocab_size), store, **kw)

    @property
    def device(self) -> torch.device:
        return self.llama_params["embed"].device

    def _prot_embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, llama dim] f32: the ESM2 mean over the non-pad tokens (CLS
        and EOS included, as the reference has it), projected."""
        from procyon_tpu_torch.models import esm2

        out = esm2.forward(self.esm_params, self.esm_cfg, tokens)
        valid = (tokens != esm2.PAD_IDX).float()[..., None]
        pooled = (out["hidden"].float() * valid).sum(1) \
            / valid.sum(1).clamp_min(1e-6)
        return pooled @ self.projector.float()

    def _build_batch(self, samples: Sequence[Tuple[int, int]]):
        """samples: (aaseq_idx, text_idx). Returns (embeds [B, S, dim] f32,
        seg [B, S], last positions [B]) with the projected protein
        embedding spliced in at <|protein|>."""
        from procyon_tpu_torch.data import protein_tokenizer as pt

        spec = self.tokenizer.spec
        dev = self.device
        pb = pt.batch_encode(
            [self.store.protein_sequence(a) for a, _ in samples],
            max_len=self.cfg.max_protein_len)
        prot = self._prot_embed(torch.from_numpy(pb.tokens).to(
            self.esm_params["embed"].device)).to(dev)

        rows = []
        for _, t in samples:
            body = self.prompt_template.replace("[EXT]", self.store.text(t))
            ids = self.tokenizer.encode(body, add_bos=True)
            rows.append(ids[:self.cfg.max_text_len])
        S = max(len(r) for r in rows)
        B = len(rows)
        tok = np.zeros((B, S), np.int64)
        seg = np.zeros((B, S), np.int32)
        last = np.zeros((B,), np.int64)
        prot_pos = np.zeros((B,), np.int64)
        for i, r in enumerate(rows):
            tok[i, :len(r)] = r
            seg[i, :len(r)] = 1
            last[i] = len(r) - 1
            hits = [j for j, x in enumerate(r) if x == spec.protein_id]
            prot_pos[i] = hits[0] if hits else 0
        embeds = self.llama_params["embed"][torch.from_numpy(tok).to(
            dev)].float()
        embeds[torch.arange(B, device=dev),
               torch.from_numpy(prot_pos).to(dev)] = prot
        return embeds, torch.from_numpy(seg).to(dev), \
            torch.from_numpy(last).to(dev)

    @torch.no_grad()
    def get_predictions(self, dataset):
        """dataset: a sequence of (aaseq_idx, text_idx, label). Returns
        (yes-probabilities, labels)."""
        from procyon_tpu_torch.models import llama

        spec = self.tokenizer.spec
        yes_all, labels_all = [], []
        for s in range(0, len(dataset), self.cfg.batch_size):
            chunk = dataset[s:s + self.cfg.batch_size]
            embeds, seg, last = self._build_batch(
                [(a, t) for a, t, _ in chunk])
            hidden = llama.forward(self.llama_params, self.llama_cfg,
                                   input_embeds=embeds, seg_ids=seg,
                                   want_logits=False)["hidden"]
            at = hidden[torch.arange(hidden.shape[0],
                                     device=hidden.device), last]
            logits = quant.mm(at, self.llama_params["lm_head"]).float()
            two = logits[:, [spec.yes_id, spec.no_id]].cpu().numpy()
            two = two - two.max(axis=1, keepdims=True)
            p = np.exp(two)
            yes_all.append(p[:, 0] / p.sum(axis=1))
            labels_all.append([y for _, _, y in chunk])
        return np.concatenate(yes_all), np.concatenate(labels_all)
