"""Checkpoint save / restore + training-state snapshots (counterpart of
procyon_tpu/training/checkpointing.py), torch-native:

  * checkpoint-{step}/state.pt: `torch.save` of the train state tree
    ({params[, frozen], opt_state: {count, mu, nu}, step}; nested dicts and
    lists of tensors in the bridge's layout, ints), read back with
    `weights_only=True`;
  * configs.json (and tokenizer.json): the model's config, written by
    models/checkpoint_io.write_configs, so that a checkpoint directory
    loads as a model (checkpoint_io.load_model);
  * training_state.json: step, mixer state and per-task progress for exact
    resume;
  * best_model_checkpoint: the early-stopping marker, which pruning keeps.

A sharded train state (more than one rank, train_step.init_train_state(...,
mesh=)) is gathered to whole leaves before the write, so the files are the
one-process layout; every rank takes part in the gather and rank 0
writes. `restore_checkpoint` reads whole leaves and shards them again for
the live state's mesh: a checkpoint written by N ranks resumes on M.
"""

import json
import os
import shutil
from typing import Dict, Optional

import torch

from procyon_tpu_torch.models.checkpoint_io import (STATE_FILE, write_configs,
                                                    write_state)


def checkpoint_dir(base: str, step: int) -> str:
    return os.path.join(base, f"checkpoint-{step}")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _state_tree(state: Dict, fn) -> Dict:
    """The state's tensor trees through fn(tree); "sharding" left out."""
    out = {k: v for k, v in state.items() if k != "sharding"}
    for k in ("params", "frozen"):
        if k in out:
            out[k] = fn(out[k])
    if "opt_state" in out:
        out["opt_state"] = {k: fn(v) if k in ("mu", "nu") else v
                            for k, v in out["opt_state"].items()}
    return out


def whole_state(state: Dict) -> Dict:
    """The train state with whole leaves (a collective on a sharded state:
    every rank calls it)."""
    sh = state.get("sharding")
    if sh is None:
        return state
    from procyon_tpu_torch.parallel.sharding import gather_params
    return _state_tree(state, lambda t: gather_params(t, sh.mesh,
                                                      sh.specs))


def save_checkpoint(base: str, step: int, state: Dict, *,
                    cfg=None, tokenizer_info: Optional[Dict] = None,
                    training_state: Optional[Dict] = None,
                    keep_last: int = 0) -> str:
    """Save the train state + JSON sidecars under checkpoint-{step}/; with
    `cfg` (a UnifiedConfig) its configs.json too. On a sharded state every
    rank calls it and rank 0 writes."""
    sh = state.get("sharding")
    state = whole_state(state)
    path = os.path.abspath(checkpoint_dir(base, step))
    if sh is not None and sh.mesh.rank != 0:
        return path
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    write_state(path, _to_cpu(state))
    if cfg is not None:
        write_configs(path, cfg, tokenizer_info=tokenizer_info)
    if training_state is not None:
        with open(os.path.join(path, "training_state.json"), "w") as f:
            json.dump(training_state, f, indent=2)
    if keep_last:
        prune_checkpoints(base, keep_last)
    return path


def list_checkpoints(base: str):
    if not os.path.isdir(base):
        return []
    steps = []
    for d in os.listdir(base):
        if d.startswith("checkpoint-"):
            try:
                steps.append(int(d.split("-", 1)[1]))
            except ValueError:
                pass
    return sorted(steps)


def prune_checkpoints(base: str, keep_last: int):
    steps = list_checkpoints(base)
    best = best_checkpoint_step(base)
    for s in steps[:-keep_last] if keep_last else []:
        if s != best:
            shutil.rmtree(checkpoint_dir(base, s), ignore_errors=True)


def latest_checkpoint(base: str) -> Optional[str]:
    steps = list_checkpoints(base)
    return checkpoint_dir(base, steps[-1]) if steps else None


def _onto(saved, like, where: str):
    """saved (CPU tree) shaped, typed and placed like `like`."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            got = sorted(saved) if isinstance(saved, dict) else type(saved)
            raise ValueError(f"checkpoint tree differs at {where or '/'}: "
                             f"{got} against {sorted(like)}")
        return {k: _onto(saved[k], v, f"{where}/{k}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(saved) != len(like):
            raise ValueError(f"checkpoint list differs at {where}")
        return type(like)(_onto(s, l, f"{where}/{i}")
                          for i, (s, l) in enumerate(zip(saved, like)))
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
            raise ValueError(f"checkpoint leaf {where}: "
                             f"{getattr(saved, 'shape', type(saved))} "
                             f"against {tuple(like.shape)}")
        return saved.to(device=like.device, dtype=like.dtype)
    return saved


def restore_checkpoint(path: str, like_state: Dict) -> Dict:
    """The state saved under `path`, each tensor on the device and in the
    dtype of the matching leaf of `like_state` (a live state of the same
    structure; a sharded one gets this rank's slices)."""
    saved = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                       map_location="cpu", weights_only=True)
    sh = like_state.get("sharding")
    if sh is None:
        return _onto(saved, like_state, "")
    from procyon_tpu_torch.parallel.sharding import shard_params
    saved = _state_tree(saved, lambda t: shard_params(t, sh.mesh,
                                                      specs=sh.specs))
    out = _onto(saved, _state_tree(like_state, lambda t: t), "")
    out["sharding"] = sh
    return out


def load_training_state(path: str) -> Optional[Dict]:
    p = os.path.join(path, "training_state.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def mark_best(base: str, step: int):
    """The early-stopping marker; under a process group rank 0 writes it."""
    if torch.distributed.is_initialized() and \
            torch.distributed.get_rank() != 0:
        return
    with open(os.path.join(base, "best_model_checkpoint"), "w") as f:
        f.write(str(step))


def best_checkpoint_step(base: str) -> Optional[int]:
    p = os.path.join(base, "best_model_checkpoint")
    if os.path.exists(p):
        with open(p) as f:
            return int(f.read().strip())
    return None


def peek_resume_state(base: str):
    """Training-state of the latest checkpoint (None if no checkpoint): lets
    callers rebuild data streams at the right position before constructing
    the trainer."""
    path = latest_checkpoint(base)
    return load_training_state(path) if path else None
