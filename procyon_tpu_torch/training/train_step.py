"""Per-task train steps (counterpart of procyon_tpu/training/train_step.py).

One step function per task family (qa / retrieval / caption / mlm),
each computing its weighted loss and updating the trainable parameters.
The host trainer interleaves them per global step with skip frequencies
(trainer.py).

Eager PyTorch has no jit and no buffer donation: a "step" is a plain
callable `step(state, batch) -> (state, metrics)` that runs the forward
and `torch.autograd.grad` over the trainable leaves, then one optimizer
update in place (the same state dict comes back, its params, moments and
step changed). Metrics are device tensors; nothing in a step reads the
device, provided the batch carries `max_position`, the host's bound of its
positions (`batch_to_device` adds it).

State: {"params": tree, "opt_state": ..., "step": int} for a full
fine-tune, plus "frozen": tree with a trainable predicate (the QLoRA
layout: quantized towers frozen, LoRA banks, projectors and the
contrastive temperature trained).

More than one rank (init_train_state(..., mesh=)): the state holds this
rank's slices of every leaf the rule table shards (parallel/sharding.py),
moments included, and "sharding" (parallel.Sharding). A step takes this
rank's rows of the global batch (parallel.shard_batch), gathers the fsdp
slices of the tree for the forward (the whole tree once a step; model
slices stay, and the towers run tensor-parallel), and reduces each
gradient over data x fsdp: a reduce-scatter for an fsdp-sharded leaf, an
all-reduce for a replicated one. Losses and metrics are global-batch
values (sums over the ranks divided by global counts,
parallel/collectives.global_mean), not means of the ranks' means; clip
norms and grad_norm are global norms.
"""

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from procyon_tpu_torch.bridge import is_leaf, merge_params
from procyon_tpu_torch.models import esm2, unified
from procyon_tpu_torch.parallel import collectives as coll
from procyon_tpu_torch.parallel import sharding as shd
from procyon_tpu_torch.training import optimizer as opt_mod
from procyon_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class TaskWeights:
    """Per-task loss weights (TrainArgs.*_loss_weight)."""
    qa: float = 1.0
    retrieval: float = 1.0
    caption: float = 1.0
    mlm: float = 1.0


def partition_params(params, predicate):
    """Split a nested-dict param tree into (trainable, frozen) by path:
    predicate("llama/layers/lora_wq/A") -> True keeps that leaf trainable.
    The subtrees share the tensors of `params` (nothing is copied)."""
    def walk(node, path):
        if is_leaf(node):
            return (node, None) if predicate(path) else (None, node)
        t, f = {}, {}
        for k, v in node.items():
            tv, fv = walk(v, f"{path}/{k}" if path else k)
            if tv is not None:
                t[k] = tv
            if fv is not None:
                f[k] = fv
        return (t or None, f or None)

    t, f = walk(params, "")
    return t or {}, f or {}


def lora_trainable_predicate(path: str) -> bool:
    """The ProCyon-QLoRA recipe: LoRA expert banks, projectors, and the
    contrastive temperature train; the (quantized) towers stay frozen."""
    return ("lora" in path or path.startswith("projectors")
            or path.startswith("contrastive"))


def init_train_state(params, optimizer, trainable_predicate=None, *,
                     mesh=None, cfg=None):
    """The train state of a whole tree. Under a mesh with an axis > 1 the
    state keeps this rank's slices (cfg, the model's config, lets a
    `model` axis split attention by whole heads) and "sharding"."""
    sharding = None
    if mesh is not None and not mesh.trivial:
        specs = shd.param_shardings(params, mesh, cfg)
        params = shd.shard_params(params, mesh, specs=specs)
        sharding = shd.Sharding(mesh, specs)
    if trainable_predicate is None:
        state = {"params": params, "opt_state": optimizer.init(params),
                 "step": 0}
    else:
        trainable, frozen = partition_params(params, trainable_predicate)
        state = {"params": trainable, "frozen": frozen,
                 "opt_state": optimizer.init(trainable), "step": 0}
    if sharding is not None:
        state["sharding"] = sharding
    return state


def state_mesh(state):
    sh = state.get("sharding")
    return sh.mesh if sh is not None else None


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _batch_group(mesh):
    return mesh.group("batch") if mesh is not None else None


def lm_loss_fn(params, cfg, batch, weight, lora_expert=0, mesh=None):
    out = unified.forward(params, cfg, batch, retrieval=False,
                          lora_expert=lora_expert,
                          max_position=batch.get("max_position"), mesh=mesh)
    group = _batch_group(mesh)
    # optional per-batch loss rescale (per-dataset caption loss weights)
    batch_w = batch.get("loss_weight", 1.0)
    loss = out["lm_loss"] * weight * batch_w
    logits = out["logits"][:, :-1]
    labels = batch["labels"][:, 1:].long()
    mask = labels != -100
    correct = (logits.argmax(-1) == labels) & mask
    acc = coll.global_mean(correct.sum(), mask.sum(), group)
    ppl = torch.exp(torch.clamp(out["lm_loss"], max=20.0))
    metrics = {"lm_loss": out["lm_loss"], "token_acc": acc, "ppl": ppl}
    if batch.get("qa_labels") is not None and \
            batch.get("answer_pos") is not None and \
            batch.get("yes_token") is not None:
        # train-time QA yes/no accuracy at the [ANSWER] position
        logits_all = out["logits"]
        B = logits_all.shape[0]
        at = logits_all[torch.arange(B, device=logits_all.device),
                        batch["answer_pos"].long()]
        pred_yes = _column(at, batch["yes_token"]) \
            > _column(at, batch["no_token"])
        hit = (pred_yes == (batch["qa_labels"] > 0)).float()
        metrics["qa_acc"] = hit.mean() if group is None else \
            coll.global_mean(hit.sum(), torch.tensor(B, device=hit.device),
                             group)
    return loss, metrics


def _column(x, token):
    """x[:, token] for a host int / 0-d array or a 0-d device tensor (a
    micro-batch's slice), without reading the device."""
    if isinstance(token, torch.Tensor):
        return x.index_select(1, token.reshape(1).long())[:, 0]
    return x[:, int(token)]


def retrieval_loss_fn(params, cfg, batch, weight, lora_expert=0,
                      mesh=None):
    # the LM head and loss are dead code here (the reference's jit drops
    # them); eager PyTorch is told so
    batch = {k: v for k, v in batch.items() if k != "labels"}
    out = unified.forward(params, cfg, batch, retrieval=True,
                          lora_expert=lora_expert, want_logits=False,
                          max_position=batch.get("max_position"), mesh=mesh)
    loss = out["retrieval_loss"] * weight
    return loss, {"retrieval_loss": out["retrieval_loss"],
                  **out["retrieval_metrics"]}


def mlm_loss_fn(params, cfg, batch, weight, lora_expert=0, mesh=None):
    """The encoder's masked-LM loss and accuracy over the masked residues
    (labels other than -100), mean over them. Under a mesh, shard_batch
    keeps protein_tokens whole (a shared bank of the other tasks) and
    splits mlm_labels, so each rank takes its block of the token rows
    here."""
    tokens, labels = batch["protein_tokens"], batch["mlm_labels"]
    group = _batch_group(mesh)
    if group is not None and tokens.shape[0] != labels.shape[0]:
        tokens = shd.shard_batch({"rows": tokens}, mesh)["rows"]
    logits = unified.protein_mlm_logits(params, cfg, tokens,
                                        lora_expert=lora_expert, mesh=mesh)
    labels = labels.long()                   # -100 = not masked
    mask = labels != -100
    safe = torch.where(mask, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, 0.0)
    loss = coll.global_mean(nll.sum(), mask.sum(), group)
    acc = coll.global_mean(((logits.argmax(-1) == labels) & mask).sum(),
                           mask.sum(), group)
    return loss * weight, {"mlm_loss": loss, "mlm_acc": acc}


_LOSS_FNS = {
    "qa": lm_loss_fn,
    "caption": lm_loss_fn,
    "retrieval": retrieval_loss_fn,
    "mlm": mlm_loss_fn,
}

# task-indexed LoRA expert selection (the reference's manual expert cycling:
# qa=0, retrieval=1, mlm/caption=2, joint=3)
TASK_LORA_EXPERT = {"qa": 0, "retrieval": 1, "caption": 2, "mlm": 2}


def lora_num_experts(cfg: unified.UnifiedConfig) -> int:
    """Bank size for expert cycling over both towers; a tower with a
    smaller bank reads its last expert for a larger index (lora.apply
    clamps it)."""
    n = cfg.llama.lora.num_experts if cfg.llama.lora is not None else 1
    if cfg.esm is not None and cfg.esm.lora is not None:
        n = max(n, cfg.esm.lora.num_experts)
    return n


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def value_and_grad(optimizer, state, frozen_base, loss_of):
    """(loss, metrics, items, grads): loss_of(params) differentiated over
    the optimizer's trainable leaves of state["params"] (requires_grad is
    switched on for the call only; with frozen_base, loss_of gets the
    trainable tree merged with state["frozen"]). items are the (path,
    leaf) pairs of `optimizer.trainable_items`, grads theirs in order;
    unreached leaves get zero grads. On a sharded state loss_of gets the
    fsdp-gathered tree, and the grads are reduced to this rank's slices
    (collectives.reduce_grad)."""
    params = state["params"]
    items = optimizer.trainable_items(params)
    sh = state.get("sharding")
    frozen = state.get("frozen")
    if sh is not None:
        params = shd.gather_params(params, sh.mesh, sh.specs, ("fsdp",))
        if frozen_base:
            frozen = shd.gather_params(frozen, sh.mesh, sh.specs, ("fsdp",))
    leaves = [t for _, t in optimizer.trainable_items(params)]
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            with profiling.span("train.forward"):
                full = merge_params(params, frozen) if frozen_base \
                    else params
                loss, metrics = loss_of(full)
            # a loss that reaches no trained leaf (an MLM phase whose
            # expert lies past the encoder's bank) has zero gradients
            with profiling.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves,
                                            allow_unused=True) \
                    if loss.requires_grad else [None] * len(leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    if sh is not None:
        grads = [coll.reduce_grad(g, sh.spec(p), sh.mesh)
                 for (p, _), g in zip(items, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, items, grads


def _apply_updates(state, optimizer, items, grads):
    optimizer.update(items, grads, state["opt_state"],
                     sharding=state.get("sharding"))
    state["step"] = int(state["step"]) + 1
    return state


def grad_norm(state, items, grads):
    """The global norm of the trainable grads (over every rank's slices
    on a sharded state)."""
    return opt_mod.global_norm(grads, paths=[p for p, _ in items],
                               sharding=state.get("sharding"))


def _micro(batch, i: int):
    """Micro-batch i of a stacked batch (tensors carry a leading [N] axis;
    host values such as max_position pass through)."""
    return {k: v[i] if isinstance(v, (torch.Tensor, np.ndarray))
            and v.ndim > 0 else v for k, v in batch.items()}


def make_train_step(cfg: unified.UnifiedConfig, optimizer, task: str,
                    weight: float = 1.0,
                    accumulation_steps: int = 1, frozen_base: bool = False):
    """A train step for one task family.

    accumulation_steps > 1: the step takes a batch whose leaves carry a
    leading [N, ...] micro-batch axis (`stack_microbatches`), runs forward
    and backward per micro-batch (each one's activations freed before the
    next), sums the grads in f32, divides by N, casts them to the params'
    dtypes and applies one update.

    frozen_base=True is the QLoRA surface: the state comes from
    init_train_state(..., trainable_predicate=...), grads flow only to the
    trainable subtree and the frozen (possibly int8 / int4) towers merge in
    as constants. The update is in place.

    Metrics: the loss's, "loss", and "grad_norm", the global norm of all
    trainable grads before clipping."""
    loss_fn = _LOSS_FNS[task]
    expert = TASK_LORA_EXPERT.get(task, 0) % max(lora_num_experts(cfg), 1)

    def run(state, batch):
        mesh = state_mesh(state)
        return value_and_grad(optimizer, state, frozen_base,
                              lambda p: loss_fn(p, cfg, batch, weight,
                                                lora_expert=expert,
                                                mesh=mesh))

    if accumulation_steps <= 1:
        def step(state, batch):
            with profiling.span("train.step"):
                loss, metrics, items, grads = run(state, batch)
                with profiling.span("train.optimizer"):
                    _apply_updates(state, optimizer, items, grads)
                    norm = grad_norm(state, items, grads)
            return state, dict(metrics, loss=loss, grad_norm=norm)
        return step

    def step(state, batches):
        with profiling.span("train.step"):
            acc = None
            losses: List[torch.Tensor] = []
            mstack: Dict[str, list] = {}
            for i in range(accumulation_steps):
                loss, metrics, items, grads = run(state, _micro(batches, i))
                acc = [g.float() for g in grads] if acc is None else \
                    [a + g.float() for a, g in zip(acc, grads)]
                losses.append(loss)
                for k, v in metrics.items():
                    mstack.setdefault(k, []).append(v)
            grads = [(a / accumulation_steps).to(t.dtype)
                     for a, (_, t) in zip(acc, items)]
            with profiling.span("train.optimizer"):
                _apply_updates(state, optimizer, items, grads)
                norm = grad_norm(state, items, grads)
            metrics = {k: torch.stack([torch.as_tensor(x) for x in v])
                       .float().mean() for k, v in mstack.items()}
            metrics["loss"] = torch.stack(losses).float().mean()
            metrics["grad_norm"] = norm
        return state, metrics

    return step


def stack_microbatches(batches):
    """Host-side: list of collator batches -> one batch with a leading
    micro-batch axis for the accumulating train step. reference_indices
    (host bookkeeping) is dropped."""
    keys = [k for k in batches[0] if k != "reference_indices"]
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def make_eval_step(cfg: unified.UnifiedConfig, task: str):
    loss_fn = _LOSS_FNS[task]

    @torch.no_grad()
    def step(params, batch, mesh=None):
        loss, metrics = loss_fn(params, cfg, batch, 1.0, mesh=mesh)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step


def batch_to_device(batch, device, *, non_blocking: bool = False):
    """A collator batch (numpy arrays and scalars) -> tensors on `device`.
    reference_indices (host bookkeeping) is dropped; numpy scalars stay
    host values; "max_position", the largest of the batch's positions, is
    added as a host int so the step need not read it from the device."""
    with profiling.span("train.to_device"):
        out = {}
        for k, v in batch.items():
            if k == "reference_indices":
                continue
            if isinstance(v, np.ndarray) and v.ndim > 0:
                t = torch.from_numpy(np.ascontiguousarray(v))
                if non_blocking and torch.device(device).type == "cuda":
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=non_blocking)
            elif isinstance(v, torch.Tensor):
                out[k] = v.to(device, non_blocking=non_blocking)
            else:
                out[k] = v.item() if isinstance(v, np.generic) else v
        positions = batch.get("positions")
        if "max_position" not in out and isinstance(positions, np.ndarray) \
                and positions.size:
            out["max_position"] = int(positions.max())
    return out


def encode_proteins_with_mlm_mask(generator: torch.Generator,
                                  protein_tokens: torch.Tensor, *,
                                  mask_prob=0.15):
    """BERT-style residue masking: of the selected 15%, 80% -> <mask>,
    10% -> a random residue, 10% unchanged. The draws come from
    `generator` (on the tokens' device). Returns (masked_tokens, labels
    with -100 on unselected positions)."""
    shape = protein_tokens.shape
    dev = protein_tokens.device
    special = (protein_tokens == esm2.PAD_IDX) | \
              (protein_tokens == esm2.CLS_IDX) | \
              (protein_tokens == esm2.EOS_IDX)
    sel = (torch.rand(shape, generator=generator, device=dev) < mask_prob) \
        & ~special
    labels = torch.where(sel, protein_tokens, -100)
    r = torch.rand(shape, generator=generator, device=dev)
    masked = torch.where(sel & (r < 0.8), esm2.MASK_IDX, protein_tokens)
    random_tok = torch.randint(4, 24, shape, generator=generator, device=dev,
                               dtype=protein_tokens.dtype)
    masked = torch.where(sel & (r >= 0.8) & (r < 0.9), random_tok, masked)
    return masked, labels
