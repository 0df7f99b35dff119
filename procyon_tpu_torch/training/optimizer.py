"""Optimizer + LR schedules (counterpart of
procyon_tpu/training/optimizer.py).

AdamW with beta=(0.9, 0.95), weight decay 1e-3, grad clip 1.0 and
per-module learning-rate groups, with optax's semantics rather than
torch.optim's defaults, so that the port's updates are the reference's:

  * the schedule is read at the update count *before* it is incremented:
    with a linear warm-up from 0 the first update has lr 0, and so its
    weight decay is 0 too (decay is added before the lr scaling);
  * `multi_transform` runs chain(clip_by_global_norm, adamw) per label
    group: each group (protein_encoder / text_encoder / projector /
    contrastive / default) is clipped by its own global norm;
  * moments are kept in the parameter's dtype (bf16 LoRA banks keep bf16
    moments), eps = 1e-8 outside the square root, bias correction by
    1 - b**count in f32 then cast to the moment's dtype, weight decay on
    every leaf, the update added in the parameter's dtype; every constant
    (b1, b2, eps, the weight decay, the clip norm, the lr) is rounded to
    the leaf's dtype first, as optax's weakly typed constants are;
  * frozen leaves (`build_frozen_mask_optimizer`) get no moments and no
    update (optax.set_to_zero).

The one deliberate difference: a group's global norm is summed in f32
(optax sums each leaf's squares in the leaf's dtype).

On a sharded train state (parallel.Sharding) the moments are this rank's
slices, like the parameters, and every norm is global: each leaf's squared
sum is summed over the ranks that hold distinct slices of it (fsdp and /
or model), and counted once where ranks hold the same values.

Parameters are updated in place (the reference's jitted step donates its
state; in place is the eager counterpart and keeps one copy).
"""

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from procyon_tpu_torch.bridge import is_quantized_leaf

Path = Tuple[str, ...]

GROUPS = ("protein_encoder", "text_encoder", "projector", "contrastive",
          "default")


# ---------------------------------------------------------------------------
# Parameter trees: nested dicts / lists of tensors; int8 {"q","s"} and int4
# {"p","s"} dicts are single (frozen) leaves
# ---------------------------------------------------------------------------


def tree_items(tree, prefix: Path = ()) -> Iterator[Tuple[Path, object]]:
    """(path, leaf) in a fixed order (dict keys sorted); a quantized dict
    is one leaf."""
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_get(tree, path: Path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def tree_map(fn: Callable, tree):
    """A new tree of fn(leaf); quantized dicts are leaves."""
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def global_norm(tensors: Sequence[torch.Tensor], paths=None,
                sharding=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a device
    scalar: nothing is read back). With a sharding (and the tensors'
    paths), the norm of the whole leaves that the ranks' slices make up."""
    if sharding is not None:
        return _sharded_sq_sum(tensors, paths, sharding).sqrt()
    total = None
    for t in tensors:
        s = t.float().square().sum()
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return total.sqrt()


def _sharded_sq_sum(tensors, paths, sharding) -> torch.Tensor:
    """The squared sums summed by the mesh axes that slice each leaf, each
    set summed over its axes' groups."""
    from procyon_tpu_torch.parallel import collectives as coll
    mesh = sharding.mesh
    by_axes: Dict[tuple, torch.Tensor] = {}
    for t, p in zip(tensors, paths):
        spec = sharding.spec(p)
        key = tuple(a for a in ("fsdp", "model") if a in spec)
        s = t.float().square().sum()
        by_axes[key] = s if key not in by_axes else by_axes[key] + s
    dev = tensors[0].device if len(tensors) else None
    total = torch.zeros((), device=dev)
    for key in sorted(by_axes):
        s = by_axes[key]
        for axis in key:
            s = coll.all_reduce(s, mesh.group(axis))
        total = total + s
    return total


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    # per-module overrides; None -> use base lr
    protein_encoder_lr: Optional[float] = None
    text_encoder_lr: Optional[float] = None
    projector_lr: Optional[float] = None
    contrastive_lr: Optional[float] = None
    weight_decay: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 1000
    total_steps: int = 100_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_ratio: float = 0.1


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (polynomial, power 1, no transition begin)."""
    def fn(count):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return fn


def make_schedule(cfg: OptimizerConfig, base_lr: float) -> Callable[[int],
                                                                    float]:
    """count -> lr (a Python float; the step casts it to f32): linear
    warm-up from 0 over warmup_steps, then cosine / linear decay to
    base_lr * min_lr_ratio over the remaining steps, or constant."""
    warmup = _linear(0.0, base_lr, cfg.warmup_steps)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "cosine":
        def decay(count):
            c = min(float(count), float(decay_steps))
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return base_lr * ((1 - cfg.min_lr_ratio) * cosine
                              + cfg.min_lr_ratio)
    elif cfg.schedule == "linear":
        decay = _linear(base_lr, base_lr * cfg.min_lr_ratio, decay_steps)
    elif cfg.schedule == "constant":
        def decay(count):
            return base_lr
    else:
        raise ValueError(cfg.schedule)

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return warmup(count)
        return decay(count - cfg.warmup_steps)
    return schedule


def group_of(path: Path) -> str:
    """A parameter path's LR group (trainIT.py:2148-2225 semantics)."""
    top = path[0] if path else ""
    return {"esm": "protein_encoder", "llama": "text_encoder",
            "projectors": "projector",
            "contrastive": "contrastive"}.get(top, "default")


# ---------------------------------------------------------------------------
# AdamW per group
# ---------------------------------------------------------------------------


class GroupedAdamW:
    """optax.multi_transform({group: chain(clip_by_global_norm(clip),
    adamw(schedule_group, b1, b2, weight_decay))}, labels), optionally
    under a freeze mask. Built by `build_optimizer` /
    `build_frozen_mask_optimizer`.

    The state (`init`) is {"count": int, "mu": tree, "nu": tree}, the moment
    trees shaped like the trainable leaves; `update` changes the params and
    the state in place."""

    def __init__(self, cfg: OptimizerConfig, group_lrs: Dict[str, float],
                 frozen_fn: Optional[Callable[[Path], bool]] = None):
        self.cfg = cfg
        self.schedules = {g: make_schedule(cfg, lr)
                          for g, lr in group_lrs.items()}
        self.frozen_fn = frozen_fn

    def trainable(self, path: Path, leaf) -> bool:
        """Leaves the optimizer updates: floating tensors outside the freeze
        mask. A quantized leaf is never one (the reference cannot take a
        gradient of an integer array either)."""
        if self.frozen_fn is not None and self.frozen_fn(path):
            return False
        if is_quantized_leaf(leaf):
            raise TypeError(
                f"{'/'.join(path)} is a quantized leaf and cannot train: "
                "freeze it (frozen_base=True or a freeze mask)")
        return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()

    def trainable_items(self, params) -> List[Tuple[Path, torch.Tensor]]:
        return [(p, t) for p, t in tree_items(params)
                if self.trainable(p, t)]

    def init(self, params) -> Dict:
        keep = {p for p, _ in self.trainable_items(params)}

        def zeros(prefix_tree, prefix: Path):
            if isinstance(prefix_tree, dict) and \
                    not is_quantized_leaf(prefix_tree):
                out = {}
                for k, v in prefix_tree.items():
                    z = zeros(v, prefix + (str(k),))
                    if z is not None:
                        out[k] = z
                return out or None
            if isinstance(prefix_tree, (list, tuple)):
                items = [zeros(v, prefix + (str(i),))
                         for i, v in enumerate(prefix_tree)]
                return items if any(x is not None for x in items) else None
            return torch.zeros_like(prefix_tree) if prefix in keep else None

        return {"count": 0, "mu": zeros(params, ()) or {},
                "nu": zeros(params, ()) or {}}

    @torch.no_grad()
    def update(self, items: Sequence[Tuple[Path, torch.Tensor]],
               grads: Sequence[torch.Tensor], state: Dict,
               sharding=None) -> None:
        """One optimizer step over `items` (the trainable (path, param)
        pairs, as `trainable_items` gives them) with their `grads`; params,
        moments and the count change in place. With a sharding the items
        are this rank's slices and each group's clip norm is global."""
        cfg = self.cfg
        count = int(state["count"])
        count_inc = count + 1
        # optax: 1 - decay**count in f32, cast to the moment's dtype
        bc1 = float(np.float32(1) - np.float32(cfg.b1) ** np.int32(
            count_inc))
        bc2 = float(np.float32(1) - np.float32(cfg.b2) ** np.int32(
            count_inc))
        by_group: Dict[str, List[int]] = {}
        for i, (path, _) in enumerate(items):
            by_group.setdefault(group_of(path), []).append(i)
        for group, idx in by_group.items():
            lr = float(np.float32(self.schedules[group](count)))
            norm = global_norm([grads[i] for i in idx],
                               [items[i][0] for i in idx], sharding)
            clip = norm < cfg.grad_clip
            for i in idx:
                path, p = items[i]
                dt = p.dtype

                def c(x):
                    # optax's Python-float constants are weakly typed: they
                    # round to the leaf's dtype before the operation (a
                    # fill, not a copy from the host, which would wait for
                    # the device)
                    return torch.full((), x, dtype=dt, device=p.device)

                g = grads[i].to(dt)
                g = torch.where(clip, g, (g / norm.to(dt)) * c(cfg.grad_clip))
                mu = tree_get(state["mu"], path)
                nu = tree_get(state["nu"], path)
                mu.copy_(c(1 - cfg.b1) * g + c(cfg.b1) * mu)
                nu.copy_(c(1 - cfg.b2) * g.square() + c(cfg.b2) * nu)
                u = (mu / c(bc1)) / (torch.sqrt(nu / c(bc2)) + c(1e-8))
                u = u + c(cfg.weight_decay) * p
                p.copy_(p + c(-lr) * u)
        state["count"] = count_inc


def _group_lrs(cfg: OptimizerConfig) -> Dict[str, float]:
    def lr_or_default(x):
        return cfg.lr if x is None else x

    return {"protein_encoder": lr_or_default(cfg.protein_encoder_lr),
            "text_encoder": lr_or_default(cfg.text_encoder_lr),
            "projector": lr_or_default(cfg.projector_lr),
            "contrastive": lr_or_default(cfg.contrastive_lr),
            "default": cfg.lr}


def build_optimizer(cfg: OptimizerConfig) -> GroupedAdamW:
    """Per-group AdamW; the groups follow each leaf's path."""
    return GroupedAdamW(cfg, _group_lrs(cfg))


def build_frozen_mask_optimizer(cfg: OptimizerConfig,
                                frozen_fn: Callable[[Path], bool]
                                ) -> GroupedAdamW:
    """build_optimizer under a freeze mask (the reference's freeze modes:
    freeze_protein_encoder / freeze_text_encoder): frozen_fn(path) with
    path a tuple of keys; frozen leaves get no update."""
    return GroupedAdamW(cfg, _group_lrs(cfg), frozen_fn=frozen_fn)
