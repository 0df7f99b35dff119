"""Parameter bridge: the JAX package's parameter pytrees -> torch tensors.

Layout decisions live here and nowhere else:
  * dense weights keep the JAX `[in, out]` layout, so the port computes
    `x @ w` exactly as the reference does (no nn.Linear `[out, in]` flip);
  * int8-quantized leaves keep their JAX form `{"q": int8 [..., in, out],
    "s": f32 [..., 1, out]}` (procyon_tpu/ops/quant.py);
  * the fused LN+int8 MLP kernel multiplies with k-contiguous weights
    (mma.sync's "col" B operand), so `int8_k_major` gives it the
    transposed `[out, in]` copy of a quantized weight.

Leaves may be numpy arrays or anything `np.asarray` accepts (a JAX array
converts without this module importing jax). bfloat16 leaves (ml_dtypes
bfloat16 in numpy) cross bit-exactly through an int16 view.
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
    dtypes kept."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device=device) for v in tree)
    return _leaf_to_tensor(tree, device)


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
    innermost, as the fused MLP kernel's mma.sync B operand reads it."""
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
