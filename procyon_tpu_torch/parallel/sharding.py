"""Parameter and batch sharding (counterpart of
procyon_tpu/parallel/sharding.py).

The rule table is the JAX package's, path for path: a leaf's path (keys
joined by "/", a quantized leaf's parts ending in /q, /s or /p, which no
rule matches, so quantized leaves stay replicated) picks a spec naming a
mesh axis or None per dimension, and a dimension that does not divide its
axis is replicated (`_fit_spec`). Each rank keeps its slice of every
sharded dimension (`shard_params`); `gather_params` rebuilds whole leaves
along the axes asked for.

One departure (ROADMAP.md, section 3): the port splits whole kv heads
only. GSPMD can split one head's lanes and add the partial sums; the
port's attention kernels work a head at a time. So where `model` does not
divide a tower's kv heads (or its heads), that tower's w[qkv] and wo stay
whole on `model` (their LoRA banks, biases and prefix rows are never split
by the table; the forward takes a rank's columns of them), and its MLP is
still split; the results are the same.
"""

import re
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from procyon_tpu_torch.parallel.mesh import AXES

Spec = Tuple[Optional[str], ...]

# (path regex, spec). Specs may name axes a leaf does not divide into;
# _fit_spec drops those axes.
_RULES = [
    # llama / esm embeddings [V, D]: vocab over fsdp
    (r".*embed$", ("fsdp", None)),
    # stacked attention projections [L, in, out]
    (r".*attn/w[qkv]$", (None, "fsdp", "model")),
    (r".*attn/wo$", (None, "model", "fsdp")),
    (r".*attn/b[qkvo]$", (None, None)),
    # stacked MLPs [L, in, out]
    (r".*mlp/w_gate$", (None, "fsdp", "model")),
    (r".*mlp/w_up$", (None, "fsdp", "model")),
    (r".*mlp/w_down$", (None, "model", "fsdp")),
    (r".*mlp/w1$", (None, "fsdp", "model")),
    (r".*mlp/w2$", (None, "model", "fsdp")),
    (r".*mlp/b[12]$", (None, None)),
    # lm head [D, V]
    (r".*lm_head$", ("fsdp", "model")),
    (r".*lm_head/dense_w$", ("fsdp", None)),
    # projectors [in, out]: shard the big input dim
    (r".*projectors/.*/w$", ("fsdp", None)),
    # LoRA banks [E, in, r] / [E, r, out]
    (r".*/A$", (None, "fsdp", None)),
    (r".*/B$", (None, None, "fsdp")),
]

# the attention leaves that follow the whole-kv-head rule
_ATTN = re.compile(r".*attn/(w[qkv]|wo)$")


def _fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop sharded axes that don't divide the leaf's dim (replicate
    there)."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None)
            continue
        size = mesh.shape[axis]
        if size > 1 and shape[i] % size == 0 and shape[i] >= size:
            out.append(axis)
        else:
            out.append(None)
    out = out[:len(shape)] + [None] * (len(shape) - len(out))
    return tuple(out)


def spec_for(path_str: str, shape, mesh) -> Spec:
    """The JAX package's spec for a leaf (a tuple: an axis name or None per
    dimension; () replicates)."""
    for pattern, spec in _RULES:
        if re.fullmatch(pattern, path_str):
            return _fit_spec(spec, shape, mesh)
    return ()


def heads_split(n_heads: int, n_kv_heads: int, model: int) -> bool:
    """Whether a tower's attention splits over `model`: whole kv heads
    (and q heads) a rank only."""
    return model > 1 and n_kv_heads % model == 0 and n_heads % model == 0


def split_group(w, full: int, mesh):
    """The mesh's `model` group when leaf `w` holds this rank's 1/model of
    its `full` columns, None when it holds them all or is quantized
    (replicated). The forwards read a tower's split from its leaves with
    this, so a cache or pool sized from the same leaves agrees with
    them."""
    g = mesh.group("model") if mesh is not None else None
    if g is None:
        return None
    if isinstance(w, dict):
        if w["s"].shape[-1] != full:
            raise ValueError("a quantized leaf holds a slice of its columns:"
                             " quantize the whole tree, then slice it")
        return None
    if w.shape[-1] == full:
        return None
    if w.shape[-1] * mesh.shape["model"] != full:
        raise ValueError(f"a leaf of {w.shape[-1]} columns is neither "
                         f"{full} nor its 1/{mesh.shape['model']}")
    return g


def _towers(cfg) -> Dict[str, Tuple[int, int]]:
    """{path prefix: (n_heads, n_kv_heads)} of a UnifiedConfig's /
    LlamaConfig's / ESM2Config's attention towers."""
    if cfg is None:
        return {}
    if hasattr(cfg, "llama") or hasattr(cfg, "esm"):
        out = {}
        if getattr(cfg, "llama", None) is not None:
            out["llama/"] = (cfg.llama.n_heads, cfg.llama.n_kv_heads)
        if getattr(cfg, "esm", None) is not None:
            out["esm/"] = (cfg.esm.n_heads, cfg.esm.n_heads)
        return out
    return {"": (cfg.n_heads, getattr(cfg, "n_kv_heads", cfg.n_heads))}


def _tower_of(path: str, towers) -> Optional[Tuple[int, int]]:
    for prefix in sorted(towers, key=len, reverse=True):
        if path.startswith(prefix):
            return towers[prefix]
    return None


def leaf_items(tree, prefix: str = ""):
    """(path, tensor) of every tensor, a quantized leaf's parts included
    (".../wq/q"), in a fixed order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{prefix}/{k}" if prefix
                                  else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def param_shardings(params, mesh, cfg=None) -> Dict[str, Spec]:
    """{path: spec} for every tensor of the (whole) tree: the JAX rules,
    then the whole-kv-head rule against `cfg`'s towers (a model axis over
    attention needs cfg)."""
    towers = _towers(cfg)
    model = mesh.shape["model"]
    specs = {}
    for path, t in leaf_items(params):
        spec = spec_for(path, tuple(t.shape), mesh)
        if model > 1 and "model" in spec and _ATTN.fullmatch(path):
            heads = _tower_of(path, towers)
            if heads is None:
                raise ValueError(f"{path}: the model axis splits attention "
                                 "by whole heads; pass the model's cfg")
            if not heads_split(*heads, model):
                spec = tuple(None if a == "model" else a for a in spec)
        specs[path] = spec
    return specs


def sharded_axes(spec: Spec):
    return {a for a in spec if a is not None}


def _slice(t: torch.Tensor, spec: Spec, mesh, axes: Iterable[str]):
    for dim, axis in enumerate(spec):
        if axis in axes:
            n = mesh.shape[axis]
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.coords[axis] * size, size)
    return t


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{prefix}/{i}" if prefix
                                     else str(i))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    return tree


def shard_params(params, mesh, cfg=None, specs=None, axes=AXES):
    """This rank's slices of a whole tree along `axes` (each a contiguous
    copy, so the whole leaf can be freed; a serving replica slices along
    ("model",) only). A trivial mesh returns `params` itself."""
    if mesh is None or mesh.trivial:
        return params
    specs = specs if specs is not None else param_shardings(params, mesh,
                                                           cfg)

    def one(path, t):
        spec = specs.get(path, ())
        if not sharded_axes(spec) & set(axes):
            return t
        return _slice(t, spec, mesh, axes).contiguous()

    return _map_paths(one, params)




def gather_leaf(t: torch.Tensor, spec: Spec, mesh, axes=("fsdp",)):
    """The leaf whole along `axes` (not differentiable: the train step
    gathers detached shards and reduce-scatters their gradients)."""
    from procyon_tpu_torch.parallel.collectives import all_gather_dim
    for dim, axis in enumerate(spec):
        if axis in axes:
            t = all_gather_dim(t, mesh.group(axis), dim)
    return t


def gather_params(params, mesh, specs, axes=("fsdp", "model")):
    """Whole leaves along `axes` from this rank's slices: ("fsdp",) for a
    step's forward (model slices stay), both for a checkpoint."""
    if mesh is None or mesh.trivial:
        return params
    return _map_paths(lambda p, t: gather_leaf(t, specs.get(p, ()), mesh,
                                               axes), params)


def replicate(tree, mesh=None):
    """Every rank holds the whole tree already (the same seed, the same
    batch): nothing moves. Kept for the JAX package's surface."""
    return tree


# batch entries that are shared banks / scalars, not per-example rows
_REPLICATED_BATCH_KEYS = {"protein_embeds", "drug_embeds", "struct_embeds",
                          "protein_tokens", "protein_group_ids",
                          "protein_row_valid", "yes_token", "no_token",
                          "loss_weight"}


def shard_batch(batch: Any, mesh):
    """This rank's rows of a global batch: per-example arrays split over
    data x fsdp (data major), shared banks and scalars whole. A batch that
    data x fsdp does not divide raises."""
    n = mesh.size("batch") if mesh is not None else 1
    if n == 1:
        return batch
    idx = mesh.index("batch")

    def one(key, x):
        if key in _REPLICATED_BATCH_KEYS or getattr(x, "ndim", 0) == 0 \
                or key == "max_position":
            return x
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"batch key {key!r}: {rows} rows do not "
                             f"divide over {n} data x fsdp ranks")
        size = rows // n
        return x[idx * size:(idx + 1) * size]

    if isinstance(batch, dict):
        return {k: one(k, v) for k, v in batch.items()}
    return one("", batch)


class Sharding:
    """A sharded train state's mesh and specs: what a step needs to gather
    the forward's leaves, reduce their gradients, take global norms and
    write whole checkpoints."""

    def __init__(self, mesh, specs: Dict[str, Spec]):
        self.mesh = mesh
        self.specs = specs

    def spec(self, path) -> Spec:
        key = "/".join(path) if isinstance(path, tuple) else path
        return self.specs.get(key, ())


def batch_sharding(mesh=None, ndim: int = 2) -> Spec:
    """A per-example array's spec: rows over (data, fsdp) combined, the
    standard FSDP recipe (fsdp ranks also take distinct rows)."""
    return (("data", "fsdp"),) + (None,) * (ndim - 1)
