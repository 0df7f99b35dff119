"""Quantization quality probes: weight fidelity, CE delta and logit cosine
against bf16 (counterpart of procyon_tpu/evaluate/quant_quality.py; torch
and numpy, the gates copied as they are).

What is gated (random weights: there are no released checkpoints):
  * ``weight_rel_err``: the largest ||dequant(quant(w)) - w||_F / ||w||_F
    over quantized leaves, per layer for stacked leaves (int8 about 1%,
    int4 groups of 128 about 11% on Gaussian weights), and its spread (the
    largest over the median): one mis-scaled layer is an outlier;
  * ``ce_delta``: mean extra nats a token of the quantized model's
    distribution under the bf16 model's (cross-entropy minus the bf16
    entropy);
  * ``topk_overlap`` of the last token's top-10 for the int8 modes.

Reported, not gated on random weights: the last token's logit cosine (deep
random networks amplify small perturbations; pass ``gate_cos`` on a real
checkpoint).

`probe` builds a bf16 decoder on `device` from a seed (or takes the given
one), quantizes it with `llama.quantize_params` and compares the two
forwards' logits on the same random tokens.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from procyon_tpu_torch.models import llama
from procyon_tpu_torch.ops import quant

WEIGHT_ERR_GATES = {4: 0.18, 8: 0.02}
CE_DELTA_GATES = {
    ("int8", "dequant"): 0.05,
    ("int8", "w8a8"): 0.08,
    ("int4", "dequant"): 0.75,
}
WEIGHT_SPREAD_GATES = {4: 1.25, 8: 1.3}
TOPK_OVERLAP_GATES = {
    ("int8", "dequant"): 0.5,
    ("int8", "w8a8"): 0.45,
}


@dataclasses.dataclass
class QuantQualityResult:
    bits: int
    mode: str
    weight_rel_err: float
    logit_cos_min: float
    logit_cos_mean: float
    ce_delta: float
    gate_weight: float
    gate_ce: float
    gate_cos: Optional[float] = None
    weight_err_spread: float = 1.0
    topk_overlap: float = 1.0
    gate_spread: Optional[float] = None
    gate_topk: Optional[float] = None

    @property
    def passed(self) -> bool:
        ok = (self.weight_rel_err <= self.gate_weight
              and self.ce_delta <= self.gate_ce)
        if self.gate_spread is not None:
            ok = ok and self.weight_err_spread <= self.gate_spread
        if self.gate_topk is not None:
            ok = ok and self.topk_overlap >= self.gate_topk
        if self.gate_cos is not None:
            ok = ok and self.logit_cos_min >= self.gate_cos
        return ok

    def as_dict(self) -> Dict:
        out = {
            "quant_bits": self.bits,
            "quant_mode": self.mode,
            "weight_rel_err": round(self.weight_rel_err, 5),
            "weight_err_spread": round(self.weight_err_spread, 5),
            "topk_overlap": round(self.topk_overlap, 5),
            "logit_cos_min": round(self.logit_cos_min, 5),
            "logit_cos_mean": round(self.logit_cos_mean, 5),
            "ce_delta_nats": round(self.ce_delta, 5),
            "quality_gate_weight_err": self.gate_weight,
            "quality_gate_ce": self.gate_ce,
            "quality_gate_passed": bool(self.passed),
            "quality_probe_synthetic_weights": True,
        }
        if self.gate_spread is not None:
            out["quality_gate_spread"] = self.gate_spread
        if self.gate_topk is not None:
            out["quality_gate_topk"] = self.gate_topk
        if self.gate_cos is not None:
            out["quality_gate_cos"] = self.gate_cos
        return out


def _numpy32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def weight_errors(params, qparams) -> Dict[str, float]:
    """Relative Frobenius reconstruction error of each quantized leaf of
    qparams against the same path of params, keyed "['layers']['mlp']
    ['w_gate'][l]" (a stacked [L, ...] leaf reports each layer)."""
    flat: Dict[str, torch.Tensor] = {}

    def collect(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                collect(v, f"{path}['{k}']")
        else:
            flat[path] = node

    errs: Dict[str, float] = {}

    def walk(node, path=""):
        if quant.is_quantized(node) or quant.is_quantized4(node):
            w = flat.get(path)
            if w is None:
                return
            deq = _numpy32(quant.dequantize4(node)
                           if quant.is_quantized4(node)
                           else quant.dequantize(node))
            w = _numpy32(w)
            if w.ndim >= 3:
                for i in range(w.shape[0]):
                    errs[f"{path}[{i}]"] = float(
                        np.linalg.norm(deq[i] - w[i])
                        / max(np.linalg.norm(w[i]), 1e-8))
            else:
                errs[path] = float(np.linalg.norm(deq - w)
                                   / max(np.linalg.norm(w), 1e-8))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}['{k}']")

    collect(params)
    walk(qparams)
    return errs


def weight_reconstruction_error(params, qparams) -> float:
    """The largest relative Frobenius error over quantized leaves."""
    return max(weight_errors(params, qparams).values(), default=0.0)


def topk_overlap(ref_logits: np.ndarray, got_logits: np.ndarray,
                 k: int = 10) -> float:
    """Mean |top-k(ref) & top-k(got)| / k over rows."""
    ref_top = np.argsort(-ref_logits, axis=-1)[..., :k]
    got_top = np.argsort(-got_logits, axis=-1)[..., :k]
    inter = [len(set(a) & set(b)) for a, b in
             zip(ref_top.reshape(-1, k), got_top.reshape(-1, k))]
    return float(np.mean(inter) / k)


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def ce_delta(ref_logits: np.ndarray, got_logits: np.ndarray) -> float:
    """Mean extra nats of `got`'s distribution under `ref`'s over the last
    axis: the cross-entropy of got under p_ref minus p_ref's entropy, each
    averaged over the other axes (the reference's ``ce_delta``)."""
    p_ref = np.exp(_log_softmax(ref_logits))
    ce_q = -(p_ref * _log_softmax(got_logits)).sum(-1).mean()
    ce_r = -(p_ref * _log_softmax(ref_logits)).sum(-1).mean()
    return float(ce_q - ce_r)


def probe(bits: int = 8, mode: str = "dequant", *, dim: int = 1024,
          layers: int = 4, batch: int = 4, seq: int = 128, seed: int = 0,
          vocab: int = 32000, cfg=None, params=None,
          gate_cos: Optional[float] = None,
          gate_weight: Optional[float] = None,
          gate_ce: Optional[float] = None,
          gate_spread: Optional[float] = None,
          gate_topk: Optional[float] = None,
          qparams=None, device="cuda") -> QuantQualityResult:
    """Build a bf16 decoder on `device` (or take cfg / params, on their own
    device), quantize it (or take qparams: a test can hand in a broken
    tree), and compare."""
    key = ("int" + str(bits), mode)
    gate_weight = WEIGHT_ERR_GATES[bits] if gate_weight is None \
        else gate_weight
    gate_ce = CE_DELTA_GATES.get(key, 1.0) if gate_ce is None else gate_ce
    if gate_spread is None:
        gate_spread = WEIGHT_SPREAD_GATES.get(bits)
    if gate_topk is None:
        gate_topk = TOPK_OVERLAP_GATES.get(key)

    if cfg is None:
        cfg = llama.LlamaConfig(
            vocab_size=vocab, dim=dim, n_layers=layers,
            n_heads=max(dim // 128, 1), n_kv_heads=max(dim // 256, 1),
            intermediate=int(dim * 2.6875), max_seq_len=seq,
            dtype=torch.bfloat16)
    if params is None:
        params = llama.init_params(seed, cfg, device=device)
    if qparams is None:
        qparams = llama.quantize_params(params, cfg, bits=bits)
    qcfg = dataclasses.replace(cfg, quant_mode=mode)

    errs = weight_errors(params, qparams)
    vals = np.asarray(sorted(errs.values())) if errs else np.zeros(1)
    w_err = float(vals.max())
    spread = float(vals.max() / max(np.median(vals), 1e-12))

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(4, cfg.vocab_size, (batch, seq)),
                             dtype=torch.int32,
                             device=params["embed"].device)
    with torch.no_grad():
        ref = _numpy32(llama.forward(params, cfg, tokens=tokens)["logits"])
        got = _numpy32(llama.forward(qparams, qcfg,
                                     tokens=tokens)["logits"])

    last_ref, last_got = ref[:, -1], got[:, -1]
    cos = (last_ref * last_got).sum(-1) / np.maximum(
        np.linalg.norm(last_ref, axis=-1)
        * np.linalg.norm(last_got, axis=-1), 1e-8)
    return QuantQualityResult(
        bits=bits, mode=mode, weight_rel_err=w_err,
        logit_cos_min=float(cos.min()), logit_cos_mean=float(cos.mean()),
        ce_delta=ce_delta(ref, got), gate_weight=gate_weight,
        gate_ce=gate_ce, gate_cos=gate_cos, weight_err_spread=spread,
        topk_overlap=topk_overlap(last_ref, last_got, k=10),
        gate_spread=gate_spread, gate_topk=gate_topk)
