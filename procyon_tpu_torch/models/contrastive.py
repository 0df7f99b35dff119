"""Contrastive heads: in-batch InfoNCE (counterpart of
procyon_tpu/models/contrastive.py), forward values on one device.

Learnable temperature clamped to [0.001, 0.5], L2-normalized embeddings, an
optional negatives mask, a symmetric (seq->text + text->seq)/2 loss. The
cross-device global batch (`axis_name`, an all-gather of both sides) belongs
to training and raises NotImplementedError here (ROADMAP.md, queue 1,
training slice).
"""

import dataclasses
import math
from typing import Optional

import torch

_NOT_PORTED = ("the cross-device InfoNCE batch (axis_name) is not ported to "
               "procyon_tpu_torch yet (ROADMAP.md, queue 1, training slice)")


@dataclasses.dataclass(frozen=True)
class InfoNCEConfig:
    temperature: float = 0.07
    min_temperature: float = 0.001
    max_temperature: float = 0.5
    symmetric: bool = True
    dtype: torch.dtype = torch.float32


def init_params(cfg: InfoNCEConfig, *, device="cuda"):
    return {"log_temp": torch.tensor(math.log(cfg.temperature),
                                     dtype=torch.float32,
                                     device=torch.device(device))}


def _normalize(x):
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


def _temperature(params, cfg):
    return torch.exp(params["log_temp"]).clamp(cfg.min_temperature,
                                               cfg.max_temperature)


def _count(valid):
    return valid.sum().clamp_min(1)


def info_nce_in_batch(params, cfg: InfoNCEConfig, seq_embeds, text_embeds,
                      *, valid=None, conflict_mask=None, conflict_ids=None,
                      axis_name: Optional[str] = None):
    """Symmetric in-batch InfoNCE.

    seq_embeds, text_embeds: [N, D], row i of each a positive pair.
    valid: [N] bool, padding rows excluded from the loss and from serving
      as negatives.
    conflict_mask: [N, N] multiplicative mask, 1 = usable negative, 0 =
      known-positive collision to exclude.
    conflict_ids: [N] int, dataset-tagged text ids; column j is masked for
      row i when the ids collide off the diagonal.
    Returns (loss, metrics dict).
    """
    if axis_name is not None:
        raise NotImplementedError(_NOT_PORTED)
    temp = _temperature(params, cfg)
    z_s = _normalize(seq_embeds)
    z_t = _normalize(text_embeds)
    n = z_s.shape[0]
    dev = z_s.device
    valid = torch.ones((n,), dtype=torch.bool, device=dev) if valid is None \
        else valid.to(torch.bool)

    if conflict_ids is not None:
        id_mask = torch.where(
            conflict_ids[:, None] == conflict_ids[None, :], 0.0, 1.0)
        conflict_mask = id_mask if conflict_mask is None \
            else conflict_mask * id_mask

    logits_s2t = (z_s @ z_t.t()) / temp
    logits_t2s = (z_t @ z_s.t()) / temp
    targets = torch.arange(n, device=dev)
    col_valid = valid[None, :]

    def masked_ce(logits):
        mask = col_valid
        if conflict_mask is not None:
            # never mask out the positive itself
            pos = torch.eye(n, dtype=torch.bool, device=dev)
            mask = mask & ((conflict_mask > 0) | pos)
        logits = torch.where(mask, logits, -1e30)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, targets[:, None])[:, 0]
        return torch.where(valid, ce, 0.0).sum() / _count(valid)

    loss = masked_ce(logits_s2t)
    if cfg.symmetric:
        loss = 0.5 * (loss + masked_ce(logits_t2s))

    hit = torch.where(col_valid, logits_s2t, -1e30).argmax(-1) == targets
    pos_logits = logits_s2t.gather(1, targets[:, None])[:, 0]
    metrics = {
        "contrastive_acc": (hit & valid).sum() / _count(valid),
        "temperature": temp,
        "logits_pos": torch.where(valid, pos_logits, 0.0).mean()}
    return loss, metrics


def info_nce_explicit(params, cfg: InfoNCEConfig, seq_embeds, text_embeds,
                      neg_seq_embeds, *, valid=None):
    """InfoNCE with explicit negatives: positive pair (i, i) against K
    preset negative proteins per row. neg_seq_embeds: [N, K, D]."""
    temp = _temperature(params, cfg)
    z_s = _normalize(seq_embeds)
    z_t = _normalize(text_embeds)
    z_n = _normalize(neg_seq_embeds)
    valid = torch.ones((z_s.shape[0],), dtype=torch.bool,
                       device=z_s.device) if valid is None \
        else valid.to(torch.bool)
    pos = (z_s * z_t).sum(-1) / temp
    neg = torch.einsum("nd,nkd->nk", z_t, z_n) / temp
    logits = torch.cat([pos[:, None], neg], dim=1)
    ce = -torch.log_softmax(logits, dim=-1)[:, 0]
    loss = torch.where(valid, ce, 0.0).sum() / _count(valid)
    acc = ((logits.argmax(-1) == 0) & valid).sum() / _count(valid)
    return loss, {"contrastive_acc": acc, "temperature": temp}
