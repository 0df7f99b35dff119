"""Parameter bridge: the JAX package's parameter pytrees -> torch tensors.

Layout decisions live here and nowhere else:
  * dense weights keep the JAX `[in, out]` layout, so the port computes
    `x @ w` exactly as the reference does (no nn.Linear `[out, in]` flip);
  * int8-quantized leaves keep their JAX form `{"q": int8 [..., in, out],
    "s": f32 [..., 1, out]}` (procyon_tpu/ops/quant.py), and packed int4
    leaves theirs, `{"p": int8 [..., in/2, out], "s": f32 [..., in/group,
    1, out]}`: the same `x @ w` layout, no transpose, bytes and scales as
    they are (ops/quant.quantize4 of the bridged f32 weights gives the same
    bytes);
  * the fused LN+int8 MLP kernels multiply with k-contiguous weights
    (s8 wgmma's K-major B operand), so `int8_k_major` gives them the
    transposed `[out, in]` copy of a quantized weight.

Leaves may be numpy arrays or anything `np.asarray` accepts (a JAX array
converts without this module importing jax). bfloat16 leaves (ml_dtypes
bfloat16 in numpy) cross bit-exactly through an int16 view. A JAX train
state (params, optax Adam moments, step) maps to the port's with
`train_state_to_torch`; `to_numpy` brings the port's trees back. The
evaluation baselines' trees cross the same way: the BERT tree
(models/bert.py), the DeepGOPlus CNN tower (a list of conv dicts) and a
projection head's weights and biases (None for a bias-free layer) with
`to_torch`.
`tree_leaves`, `map_tensors` and `merge_params` walk the port's trees for
the layers above (models, training, scripts).
"""

from typing import Any

import numpy as np
import torch


def _leaf_to_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a, order="C")   # torch needs writable memory
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def to_torch(tree: Any, *, device=None) -> Any:
    """Convert a parameter pytree (nested dicts / lists of arrays) to torch,
    dtypes kept; None stays None (a bias-free layer's bias)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device=device) for v in tree)
    return _leaf_to_tensor(tree, device)


def is_quantized_leaf(node) -> bool:
    """An int8 {"q", "s"} or packed int4 {"p", "s"} weight dict."""
    return isinstance(node, dict) and len(node) == 2 and "s" in node \
        and ("q" in node or "p" in node)


def is_leaf(node) -> bool:
    """One unit of a parameter tree for freezing and merging: anything
    that is not a dict (tensors, projector lists), or a quantized dict."""
    return not isinstance(node, dict) or is_quantized_leaf(node)


def merge_params(trainable, frozen):
    """A training state's trainable tree laid over its frozen one (the
    inverse of training/train_step.partition_params)."""
    if trainable is None:
        return frozen
    if frozen is None:
        return trainable
    if is_leaf(trainable) or is_leaf(frozen):
        return trainable
    return {k: merge_params(trainable.get(k), frozen.get(k))
            for k in set(trainable) | set(frozen)}


def tree_leaves(tree):
    """Every tensor of a tree, inside quantized dicts too."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def map_tensors(fn, tree):
    """The same tree with fn(t) at every tensor, inside quantized dicts
    too."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree)


def _is_masked(x) -> bool:
    """optax's MaskedNode: a leaf that another label group owns."""
    return type(x).__name__ == "MaskedNode"


def _adam_states(node, found):
    """Every optax ScaleByAdamState (count, mu, nu) inside an optimizer
    state of nested namedtuples, tuples and dicts, in order."""
    fields = getattr(node, "_fields", None)
    if fields is not None and {"count", "mu", "nu"} <= set(fields):
        found.append(node)
    elif fields is not None:
        for f in fields:
            _adam_states(getattr(node, f), found)
    elif isinstance(node, dict):
        for v in node.values():
            _adam_states(v, found)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _adam_states(v, found)
    return found


def _overlay(trees, device):
    """One tree from the per-group moment trees: at each leaf the group
    that owns it (the others hold MaskedNode); leaves no group owns drop
    out, and so do dicts left empty."""
    first = trees[0]
    if isinstance(first, dict):
        out = {}
        for k in first:
            v = _overlay([t[k] for t in trees], device)
            if v is not None:
                out[k] = v
        return out or None
    if isinstance(first, (list, tuple)) and not _is_masked(first):
        items = [_overlay([t[i] for t in trees], device)
                 for i in range(len(first))]
        return items if any(x is not None for x in items) else None
    owned = [t for t in trees if not _is_masked(t)]
    return _leaf_to_tensor(owned[0], device) if owned else None


def train_state_to_torch(state: dict, *, device=None) -> dict:
    """A JAX train state (training/train_step.init_train_state, with or
    without a trainable predicate; optax's multi_transform of per-group
    chain(clip_by_global_norm, adamw), optionally under a freeze mask) ->
    the port's {"params"[, "frozen"], "opt_state": {"count", "mu", "nu"},
    "step"}. Parameters and moments keep their dtypes (bf16 LoRA banks and
    their moments stay bf16; int8 leaves stay {"q", "s"})."""
    adams = _adam_states(state["opt_state"], [])
    if not adams:
        raise ValueError("no Adam state found in opt_state")
    out = {"params": to_torch(state["params"], device=device),
           "opt_state": {
               "count": int(np.asarray(adams[0].count)),
               "mu": _overlay([a.mu for a in adams], device) or {},
               "nu": _overlay([a.nu for a in adams], device) or {}},
           "step": int(np.asarray(state["step"]))}
    if "frozen" in state:
        out["frozen"] = to_torch(state["frozen"], device=device)
    return out


def to_numpy(tree: Any) -> Any:
    """torch pytree -> numpy (bf16 leaves widen to f32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree


def int8_k_major(q: torch.Tensor) -> torch.Tensor:
    """int8 `[in, out]` -> contiguous `[out, in]`: the contraction axis
    innermost, as the fused MLP kernels' s8 wgmma B operand reads it
    (K-major: no transposed form exists for 8-bit types). A `[in, out]`
    view of a `[out, in]` tensor comes back without a copy."""
    assert q.dtype == torch.int8 and q.dim() == 2, (q.dtype, q.shape)
    return q.t().contiguous()


_POOL_KEYS = ("k", "v", "page_table", "seq_len")
_POOL_SCALE_KEYS = ("k_scale", "v_scale")


def _pool_keys(pool) -> tuple:
    missing = [k for k in _POOL_KEYS if k not in pool]
    scales = [k for k in _POOL_SCALE_KEYS if k in pool]
    if missing or len(scales) == 1:
        raise ValueError(f"not a paged KV pool: keys {sorted(pool)}")
    return _POOL_KEYS + tuple(scales)


def pool_to_torch(pool: dict, *, device=None) -> dict:
    """A paged KV pool of the JAX package (inference/kv_pool.py: `k`, `v`,
    `page_table`, `seq_len`, and `k_scale` / `v_scale` on int8 pools, as
    numpy arrays) -> the port's pool: the same keys, shapes and dtypes as
    tensors of their own (the port updates its pools in place), so a test
    can prefill in one package and decode in the other."""
    return {k: _leaf_to_tensor(np.array(np.asarray(pool[k]), order="C"),
                               device)
            for k in _pool_keys(pool)}


def pool_to_numpy(pool: dict) -> dict:
    """The port's pool -> numpy arrays with the dtypes kept, as
    `jnp.asarray` takes them. A bf16 leaf crosses bit-exactly through an
    int16 view, into ml_dtypes' bfloat16 (the numpy type JAX uses)."""
    out = {}
    for k in _pool_keys(pool):
        t = pool[k].detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            out[k] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[k] = t.numpy().copy()
    return out
