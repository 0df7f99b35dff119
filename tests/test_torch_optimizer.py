"""procyon_tpu_torch's optimizer (training/optimizer.py) against
procyon_tpu's optax one on the same numpy trees: the schedules, the
per-group learning rates, per-group clipping, the freeze mask and three
AdamW updates.

Tolerances: schedules four f32 ulps (5e-7 relative: the port computes
in float64 and rounds once to f32, optax rounds each f32 operation). f32
parameters 1e-6 absolute after three updates of at most lr each. bf16
leaves and their bf16 moments: one bf16 ulp of the value (2^-8 relative)
plus 1e-6.

The bf16 leaf sits in the default group, which no test clips: the port
sums a group's squares in f32 where optax sums a bf16 leaf's in bf16 (the
one deliberate difference, training/optimizer.py), so a clipped group
with a bf16 leaf is scaled by a slightly different norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from procyon_tpu.training import optimizer as jopt
from procyon_tpu_torch import bridge
from procyon_tpu_torch.training import optimizer as topt
from torch_cpu_common import one_torch_thread  # noqa: F401

F32_ATOL = 1e-6
BF16_RTOL = 2.0 ** -8


def _params(rng):
    """One leaf or more in every label group, a bf16 (LoRA) leaf, a list
    of projector layers, a scalar."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "llama": {"w": f(6, 5), "norm": f(5)},
        "projectors": {"token": [{"w": f(5, 4), "b": f(4)}]},
        "contrastive": {"log_temp": np.float32(-2.6)},
        "esm": {"w": f(7)},
        "other": {"b": f(3),
                  "lora": {"A": jnp.asarray(f(2, 5, 3), jnp.bfloat16)}},
    }


def _grads(rng, params, scale):
    """Gradients of the params' shapes; `scale` maps a top-level key to the
    size of its gradients (unequal group norms)."""
    def leaf(key, x):
        g = scale[key] * rng.standard_normal(np.shape(x))
        return jnp.asarray(g, jnp.asarray(x).dtype)

    return {k: jax.tree_util.tree_map(lambda x, k=k: leaf(k, x), v)
            for k, v in params.items()}


def _run(cfg, steps, scales, frozen=None, seed=0):
    """`steps` updates by optax and by the port from the same params and
    gradients; returns (JAX params, port params, port state, JAX state)."""
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(rng))
    tp = bridge.to_torch(jp, device="cpu")
    if frozen is None:
        jo = jopt.build_optimizer(cfg, jp)
        to = topt.build_optimizer(cfg)
    else:
        jo = jopt.build_frozen_mask_optimizer(
            cfg, jp, lambda path: str(getattr(path[0], "key", path[0]))
            in frozen)
        to = topt.build_frozen_mask_optimizer(
            cfg, lambda path: path[0] in frozen)
    js, ts_ = jo.init(jp), to.init(tp)
    for i in range(steps):
        g = _grads(rng, jp, scales[i % len(scales)])
        upd, js = jo.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        items = to.trainable_items(tp)
        tg = bridge.to_torch(g, device="cpu")
        to.update(items, [topt.tree_get(tg, p) for p, _ in items], ts_)
    return jp, tp, ts_, js


def _compare(tp, want):
    """Port tree against a JAX tree (or a port tree from the bridge)."""
    want = bridge.to_torch(want, device="cpu")
    assert [p for p, _ in topt.tree_items(tp)] == [
        p for p, _ in topt.tree_items(want)]
    for (path, t), (_, j) in zip(topt.tree_items(tp),
                                 topt.tree_items(want)):
        assert t.dtype == j.dtype, path
        g, w = t.float().numpy(), j.float().numpy()
        rtol = BF16_RTOL if t.dtype == torch.bfloat16 else 0.0
        np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=rtol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_match_optax(schedule):
    cfg = topt.OptimizerConfig(lr=3e-4, warmup_steps=4, total_steps=12,
                               schedule=schedule, min_lr_ratio=0.1)
    jsched = jopt.make_schedule(jopt.OptimizerConfig(**vars(cfg)), 3e-4)
    tsched = topt.make_schedule(cfg, 3e-4)
    assert tsched(0) == 0.0
    for count in range(16):
        np.testing.assert_allclose(np.float32(tsched(count)),
                                   np.float32(jsched(count)), rtol=5e-7,
                                   err_msg=f"count {count}")


def test_group_learning_rates_match_optax():
    """Each label group at its own rate (constant after one warm-up step),
    the first update at lr 0 (so no weight decay either)."""
    cfg = jopt.OptimizerConfig(lr=1e-2, text_encoder_lr=1e-3,
                               projector_lr=5e-3, contrastive_lr=2e-2,
                               protein_encoder_lr=3e-3, warmup_steps=1,
                               total_steps=10, schedule="constant",
                               grad_clip=100.0)
    tcfg = topt.OptimizerConfig(**vars(cfg))
    ones = {k: 1.0 for k in ("llama", "projectors", "contrastive", "esm",
                             "other")}
    jp1, tp1, _, _ = _run(tcfg, 1, [ones])
    p0 = _params(np.random.default_rng(0))
    _compare(tp1, jax.tree_util.tree_map(jnp.asarray, p0))  # lr 0 first
    jp, tp, state, _ = _run(tcfg, 3, [ones])
    _compare(tp, jp)
    assert state["count"] == 3
    assert {topt.group_of(p) for p, _ in topt.tree_items(tp)} == set(
        topt.GROUPS)


def test_clipping_is_per_group():
    """Two groups whose gradient norms differ by 100x, clip 1: the decoder
    is clipped on some steps, the projectors never; optax's
    multi_transform clips each group by its own norm, and so does the
    port (clipping by the norm of all groups would shrink the projectors'
    gradients and change their moments)."""
    cfg = topt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                               schedule="constant", grad_clip=1.0)
    big = {"llama": 3.0, "projectors": 0.03, "contrastive": 0.01,
           "esm": 0.5, "other": 0.02}
    small = dict(big, llama=0.05)
    jp, tp, _, _ = _run(cfg, 3, [big, small, big], seed=1)
    _compare(tp, jp)


def test_frozen_mask_matches_optax():
    """Frozen groups get no moments and no update (optax.set_to_zero);
    the rest train as without the mask."""
    cfg = topt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                               schedule="constant", grad_clip=1.0)
    scales = [{"llama": 0.3, "projectors": 0.3, "contrastive": 0.3,
               "esm": 0.3, "other": 0.1}]
    jp, tp, state, _ = _run(cfg, 3, scales, frozen={"esm", "llama"})
    _compare(tp, jp)
    p0 = bridge.to_torch(_params(np.random.default_rng(0)), device="cpu")
    assert torch.equal(tp["esm"]["w"], p0["esm"]["w"])
    assert torch.equal(tp["llama"]["w"], p0["llama"]["w"])
    assert set(state["mu"]) == {"projectors", "contrastive", "other"}


def test_three_adamw_updates_match_optax_moments():
    """Three cosine-scheduled updates with weight decay: the parameters and
    the moments (bf16 moments for the bf16 leaf) against optax's."""
    cfg = topt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=6,
                               weight_decay=0.1, grad_clip=1.0)
    scales = [{"llama": 0.5, "projectors": 0.2, "contrastive": 2.0,
               "esm": 0.2, "other": 0.1}]
    jp, tp, state, js = _run(cfg, 3, scales, seed=2)
    _compare(tp, jp)
    adams = bridge._adam_states(js, [])
    tj = bridge.train_state_to_torch({"params": jp, "opt_state": js,
                                      "step": 3})
    assert tj["opt_state"]["count"] == state["count"] == 3 == int(
        adams[0].count)
    assert state["mu"]["other"]["lora"]["A"].dtype == torch.bfloat16
    for key in ("mu", "nu"):
        _compare(state[key], tj["opt_state"][key])
