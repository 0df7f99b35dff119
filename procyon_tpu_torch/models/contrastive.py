"""Contrastive heads: in-batch InfoNCE (counterpart of
procyon_tpu/models/contrastive.py), differentiable.

Learnable temperature clamped to [0.001, 0.5], L2-normalized embeddings, an
optional negatives mask, a symmetric (seq->text + text->seq)/2 loss; the
explicit-negative InfoNCE, the max-margin loss and the projection head.

The global batch (`axis_name`, a torch.distributed process group over the
ranks that hold the batch's rows): both sides, the valid flags and the
conflict ids are all-gathered (parallel/collectives.all_gather_batch,
whose backward sums the ranks' gradients into each rank's rows), each
rank scores its rows against every column with its positives at
rank * n_local + i, and the loss and metrics are means over the global
batch (collectives.global_mean): the value the one-process loss has on the
whole batch, on every rank.
"""

import dataclasses
import math

import torch

from procyon_tpu_torch.models._init import Seed, make_generator
from procyon_tpu_torch.ops.norms import layer_norm
from procyon_tpu_torch.parallel import collectives as coll


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


def _group(axis_name):
    """The process group `axis_name` names: a ProcessGroup, or a string
    for the default group. There must be one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"axis_name={axis_name!r} outside any process "
                         "group: call parallel.initialize_multihost first")
    return dist.group.WORLD if isinstance(axis_name, str) else axis_name


def info_nce_in_batch(params, cfg: InfoNCEConfig, seq_embeds, text_embeds,
                      *, valid=None, conflict_mask=None, conflict_ids=None,
                      axis_name=None):
    """Symmetric in-batch InfoNCE.

    seq_embeds, text_embeds: [N, D], row i of each a positive pair (this
      rank's N rows under axis_name).
    valid: [N] bool, padding rows excluded from the loss and from serving
      as negatives.
    conflict_mask: [N, N] multiplicative mask, 1 = usable negative, 0 =
      known-positive collision to exclude; local only, so it raises with
      axis_name (pass conflict_ids), as in the JAX package.
    conflict_ids: [N] int, dataset-tagged text ids; column j is masked for
      row i when the ids collide off the diagonal.
    axis_name: the process group of the global batch (a ProcessGroup, or
      a string for the default group); raises outside any process group.
    Returns (loss, metrics dict).
    """
    group = None
    if axis_name is not None:
        if conflict_mask is not None:
            raise ValueError(
                "conflict_mask is a local [N, N] host-built mask and "
                "cannot be used with axis_name (the gathered batch has "
                "N_global columns); pass conflict_ids instead")
        group = _group(axis_name)
    temp = _temperature(params, cfg)
    z_s = _normalize(seq_embeds)
    z_t = _normalize(text_embeds)
    n = z_s.shape[0]
    dev = z_s.device
    valid = torch.ones((n,), dtype=torch.bool, device=dev) if valid is None \
        else valid.to(torch.bool)
    if group is not None:
        z_s_all = coll.all_gather_batch(z_s, group)
        z_t_all = coll.all_gather_batch(z_t, group)
        valid_all = coll.all_gather_dim(valid, group)
        offset = coll.rank(group) * n
    else:
        z_s_all, z_t_all, valid_all, offset = z_s, z_t, valid, 0

    if conflict_ids is not None:
        ids_all = coll.all_gather_dim(conflict_ids, group)
        id_mask = torch.where(
            conflict_ids[:, None] == ids_all[None, :], 0.0, 1.0)
        conflict_mask = id_mask if conflict_mask is None \
            else conflict_mask * id_mask

    # scores: local rows against global columns
    logits_s2t = (z_s @ z_t_all.t()) / temp
    logits_t2s = (z_t @ z_s_all.t()) / temp
    targets = torch.arange(n, device=dev) + offset
    col_valid = valid_all[None, :]

    def masked_ce(logits):
        mask = col_valid
        if conflict_mask is not None:
            # never mask out the positive itself
            pos = torch.nn.functional.one_hot(
                targets, logits.shape[1]).to(torch.bool) if group is not None \
                else torch.eye(n, dtype=torch.bool, device=dev)
            mask = mask & ((conflict_mask > 0) | pos)
        logits = torch.where(mask, logits, -1e30)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, targets[:, None])[:, 0]
        return coll.global_mean(torch.where(valid, ce, 0.0).sum(),
                                valid.sum(), group)

    loss = masked_ce(logits_s2t)
    if cfg.symmetric:
        loss = 0.5 * (loss + masked_ce(logits_t2s))

    hit = torch.where(col_valid, logits_s2t, -1e30).argmax(-1) == targets
    pos_logits = logits_s2t.gather(1, targets[:, None])[:, 0]
    pos_sum = torch.where(valid, pos_logits, 0.0)
    metrics = {
        "contrastive_acc": coll.global_mean((hit & valid).sum(),
                                            valid.sum(), group),
        "temperature": temp,
        "logits_pos": pos_sum.mean() if group is None else
        coll.global_mean(pos_sum.sum(), torch.tensor(n, device=dev),
                         group)}
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


def max_margin_loss(seq_embeds, text_embeds, neg_text_embeds, *,
                    margin=1.0):
    """MaxMarginContrastiveLoss analogue: hinge on cosine(pos) -
    cosine(neg) with explicit negatives [N, K, D]."""
    z_s = _normalize(seq_embeds)[:, None, :]
    z_p = _normalize(text_embeds)[:, None, :]
    z_n = _normalize(neg_text_embeds)
    pos = (z_s * z_p).sum(-1)  # [N, 1]
    neg = (z_s * z_n).sum(-1)  # [N, K]
    return torch.clamp(margin - pos + neg, min=0.0).mean()


def projection_head_init(seed: Seed, dim, proj_dim, dtype=torch.float32, *,
                         device="cuda"):
    """ProjectionHead analogue: linear-GELU-linear with residual + layer
    norm. N(0, 1/fan_in) weights from `seed` (models/_init.py)."""
    generator, device = make_generator(seed, device)

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) / fan_in ** 0.5).to(dtype)

    return {
        "proj_w": normal((dim, proj_dim), dim),
        "fc_w": normal((proj_dim, proj_dim), proj_dim),
        "fc_b": torch.zeros((proj_dim,), dtype=dtype, device=device),
        "norm_w": torch.ones((proj_dim,), dtype=dtype, device=device),
        "norm_b": torch.zeros((proj_dim,), dtype=dtype, device=device),
    }


def projection_head_apply(params, x):
    proj = x @ params["proj_w"]
    h = torch.nn.functional.gelu(proj, approximate="none") @ params["fc_w"] \
        + params["fc_b"]
    return layer_norm(h + proj, params["norm_w"], params["norm_b"])
