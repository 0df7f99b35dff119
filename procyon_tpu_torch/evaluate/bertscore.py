"""BERTScore over the port's BERT encoder (counterpart of
procyon_tpu/evaluate/bertscore.py).

The reference's primary caption metric is BERTScore with the en-sci model
(procyon/evaluate/framework/caption.py:68-103: the HF `evaluate`
bertscore wrapper with rescale_with_baseline=True; en-sci is
allenai/scibert_scivocab_uncased). bert_score's greedy matching, per
(candidate, reference) pair: embed both with the encoder, take one
intermediate layer's hidden states, L2-normalise, and match: recall is the
(idf-weighted) mean over reference tokens of the largest cosine to any
candidate token, precision the same the other way, F1 their harmonic mean.
[CLS], [SEP] and [PAD] take no part. With several references the best F1
wins; a baseline (b_p, b_r, b_f) rescales each to (s - b) / (1 - b).

On the device of the encoder's parameters: the pairs are cut into chunks
of `batch_size`, the texts of a chunk deduplicated and run through the
encoder as one padded batch (stopped after the scored layer), and the
(Tc x Tr) similarity matrices of the whole chunk reduced in one batched
call (`_pair_scores`); the host keeps the tokenizer and the best-F1
bookkeeping.
"""

import dataclasses
import json
import os
import time
from math import log
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from procyon_tpu_torch.models import bert

# bert_score pins one layer per model (model2layers); scibert (the en-sci
# scorer) reads layer 8 of 12
DEFAULT_LAYER = 8


@dataclasses.dataclass
class BERTScoreResult:
    precision: np.ndarray
    recall: np.ndarray
    f1: np.ndarray


@torch.no_grad()
def embed_layer(params, cfg: bert.BertConfig, tokens: torch.Tensor,
                layer: int) -> torch.Tensor:
    """[N, S, dim] f32 hidden states of `layer` (0: the embeddings),
    L2-normalised per token; the encoder stops after that layer."""
    h = bert.forward(params, cfg, tokens, n_layers=layer)["hidden"].float()
    return h / h.norm(dim=-1, keepdim=True).clamp_min(1e-8)


def _pair_scores(emb, mask, idf_w, cand_rows, ref_rows):
    """Greedy matching for index-paired rows of one packed batch.

    emb [N, S, d] normalised, mask [N, S] {0, 1} (specials excluded),
    idf_w [N, S] per-token weights (1 when idf is off), cand_rows /
    ref_rows [P] row indices, all on one device. Returns (P,) precision,
    recall and F1."""
    c_e, r_e = emb[cand_rows], emb[ref_rows]
    c_m, r_m = mask[cand_rows], mask[ref_rows]
    c_w, r_w = idf_w[cand_rows], idf_w[ref_rows]
    sim = torch.einsum("psd,ptd->pst", c_e, r_e)
    sim = sim * c_m[:, :, None] * r_m[:, None, :]
    neg = torch.tensor(-1e9, dtype=sim.dtype, device=sim.device)
    best_c = torch.where(c_m > 0, torch.where(
        r_m[:, None, :] > 0, sim, neg).amax(2), 0.0)
    best_r = torch.where(r_m > 0, torch.where(
        c_m[:, :, None] > 0, sim, neg).amax(1), 0.0)
    p = (best_c * c_w).sum(-1) / (c_w * c_m).sum(-1).clamp_min(1e-8)
    r = (best_r * r_w).sum(-1) / (r_w * r_m).sum(-1).clamp_min(1e-8)
    f1 = 2 * p * r / (p + r).clamp_min(1e-8)
    return p, r, f1


def compute_idf(refs: Sequence[str], tokenizer) -> Dict[int, float]:
    """bert_score's idf: log((N + 1) / (df + 1)) over the reference corpus;
    the specials get 0."""
    n = len(refs)
    df: Dict[int, int] = {}
    for t in refs:
        for tid in set(tokenizer.encode(t, add_special_tokens=False)):
            df[tid] = df.get(tid, 0) + 1
    idf = {tid: log((n + 1) / (c + 1)) for tid, c in df.items()}
    for tid in (tokenizer.cls_id, tokenizer.sep_id, tokenizer.pad_id):
        idf[tid] = 0.0
    return idf


class BERTScorer:
    """A scorer that holds its encoder: build once, score many batches.

    tokenizer: data/wordpiece.WordPieceTokenizer (or one with its API).
    baseline: an optional (p, r, f1) rescaling triple. The encoder runs on
    its parameters' device."""

    def __init__(self, params, cfg: bert.BertConfig, tokenizer, *,
                 layer: int = DEFAULT_LAYER, idf: bool = False,
                 baseline: Optional[Tuple[float, float, float]] = None,
                 max_len: int = 512, batch_size: int = 64):
        if not 0 <= layer <= cfg.n_layers:
            raise ValueError(
                f"layer {layer} out of range for a {cfg.n_layers}-layer "
                f"encoder")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.layer = layer
        self.idf = idf
        self.baseline = baseline
        # clamp to the encoder's position table; longer texts truncate, as
        # in bert_score
        self.max_len = min(max_len, cfg.max_position)
        self.batch_size = batch_size
        # filled by score(): the encoder's share of the last call's time
        # (host clock, synchronized) and its calls
        self.last_timing: Dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["word"].device

    def _encode_texts(self, texts: Sequence[str], idf_table):
        enc = self.tokenizer.batch_encode(texts, max_len=self.max_len)
        ids = enc.ids
        # specials take no part in the matching (bert_score strips them)
        mask = enc.attention_mask.astype(np.float32)
        for sid in (self.tokenizer.cls_id, self.tokenizer.sep_id):
            mask[ids == sid] = 0.0
        if idf_table is not None:
            w = np.vectorize(lambda t: idf_table.get(int(t), 1.0),
                             otypes=[np.float64])(ids)
        else:
            w = np.ones_like(mask)
        return ids, mask, w.astype(np.float32)

    @torch.no_grad()
    def score(self, candidates: Sequence[str],
              references: Sequence[Union[str, Sequence[str]]]
              ) -> BERTScoreResult:
        """references[i]: one string or a list (several: the best F1)."""
        assert len(candidates) == len(references)
        refs_lists: List[List[str]] = [
            [r] if isinstance(r, str) else list(r) for r in references]
        idf_table = (compute_idf([r for rs in refs_lists for r in rs],
                                 self.tokenizer) if self.idf else None)
        dev = self.device

        P = np.zeros(len(candidates), np.float32)
        R = np.zeros(len(candidates), np.float32)
        F = np.zeros(len(candidates), np.float32)
        pairs: List[Tuple[int, str, str]] = []
        for i, (c, rs) in enumerate(zip(candidates, refs_lists)):
            for r in rs:
                pairs.append((i, c, r))
        best_f: Dict[int, float] = {}
        t_encoder, calls = 0.0, 0
        t0 = time.perf_counter()
        for s in range(0, len(pairs), self.batch_size):
            chunk = pairs[s:s + self.batch_size]
            texts: List[str] = []
            index: Dict[str, int] = {}
            for _, c, r in chunk:
                for t in (c, r):
                    if t not in index:
                        index[t] = len(texts)
                        texts.append(t)
            ids, mask, w = self._encode_texts(texts, idf_table)
            t1 = time.perf_counter()
            emb = embed_layer(self.params, self.cfg,
                              torch.from_numpy(ids).to(dev), self.layer)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_encoder += time.perf_counter() - t1
            calls += 1
            c_rows = torch.tensor([index[c] for _, c, _ in chunk],
                                  device=dev)
            r_rows = torch.tensor([index[r] for _, _, r in chunk],
                                  device=dev)
            p, r_, f1 = _pair_scores(emb, torch.from_numpy(mask).to(dev),
                                     torch.from_numpy(w).to(dev), c_rows,
                                     r_rows)
            p, r_, f1 = (a.float().cpu().numpy() for a in (p, r_, f1))
            for j, (i, _, _) in enumerate(chunk):
                if i not in best_f or f1[j] > best_f[i]:
                    best_f[i] = float(f1[j])
                    P[i], R[i], F[i] = p[j], r_[j], f1[j]
        self.last_timing = {"seconds": time.perf_counter() - t0,
                            "encoder_seconds": t_encoder,
                            "encoder_calls": calls, "pairs": len(pairs)}

        if self.baseline is not None:
            bp, br, bf = self.baseline
            P = (P - bp) / (1 - bp)
            R = (R - br) / (1 - br)
            F = (F - bf) / (1 - bf)
        return BERTScoreResult(precision=P, recall=R, f1=F)


def compute_baseline(scorer: BERTScorer, sentences: Sequence[str], *,
                     n_pairs: int = 1000, seed: int = 0
                     ) -> Tuple[float, float, float]:
    """The rescaling baseline b: the mean BERTScore of unrelated sentence
    pairs under this scorer's (model, layer), bert_score's method. Where
    bert_score averages about 1M Common Crawl pairs, the pairs here come
    from a corpus the caller gives (e.g. the caption references): the same
    (model, layer, corpus, seed) give the same b, and rescaled scores are
    comparable across runs that share a baseline file. Pairs (s_i, s_j),
    i != j, by shifting shuffles; scored with the scorer's idf setting and
    no baseline. Returns the (p, r, f1) means."""
    assert len(sentences) >= 2, "need at least two sentences"
    rng = np.random.default_rng(seed)
    sents = list(sentences)
    cands: List[str] = []
    refs: List[str] = []
    while len(cands) < n_pairs:
        perm = rng.permutation(len(sents))
        shift = np.roll(perm, 1)
        for i, j in zip(perm, shift):
            if sents[i] != sents[j]:
                cands.append(sents[i])
                refs.append(sents[j])
            if len(cands) >= n_pairs:
                break
    saved = scorer.baseline
    scorer.baseline = None
    try:
        res = scorer.score(cands, refs)
    finally:
        scorer.baseline = saved
    return (float(res.precision.mean()), float(res.recall.mean()),
            float(res.f1.mean()))


def load_baseline(path: str) -> Tuple[float, float, float]:
    """A baseline JSON as scripts/compute_bertscore_baseline.py writes it
    ({"precision": b_p, "recall": b_r, "f1": b_f, ...})."""
    with open(path) as f:
        d = json.load(f)
    return (float(d["precision"]), float(d["recall"]), float(d["f1"]))


def make_scorer(checkpoint_dir: Optional[str] = None, *,
                vocab_file: Optional[str] = None,
                layer: int = DEFAULT_LAYER, idf: bool = False,
                dtype: Optional[torch.dtype] = None, seed: int = 0,
                baseline_file: Optional[str] = None, device="cuda",
                **kw) -> BERTScorer:
    """A scorer from a local HF BERT checkpoint directory (weights and
    vocab.txt), or, with none, from synthetic weights: the 2-layer tiny
    encoder, seeded, and the synthetic WordPiece vocabulary (the metric's
    math is exact either way; absolute scores need real weights). dtype
    defaults to f32 on the CPU and bf16 elsewhere (the flash kernel's).
    baseline_file: rescaling constants (compute_bertscore_baseline), the
    reference's rescale_with_baseline=True."""
    from procyon_tpu_torch.data.wordpiece import WordPieceTokenizer

    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if baseline_file:
        kw = {**kw, "baseline": load_baseline(baseline_file)}
    if checkpoint_dir:
        params, cfg = bert.load_hf_checkpoint(checkpoint_dir, dtype=dtype,
                                              device=device)
        vocab_file = vocab_file or os.path.join(checkpoint_dir, "vocab.txt")
        tokenizer = WordPieceTokenizer.from_vocab_file(vocab_file)
    else:
        cfg = bert.tiny_config(n_layers=2, dtype=dtype)
        params = bert.init_params(seed, cfg, device=device)
        tokenizer = WordPieceTokenizer.synthetic()
        layer = min(layer, cfg.n_layers)
    return BERTScorer(params, cfg, tokenizer, layer=layer, idf=idf, **kw)
