"""procyon_tpu_torch's training losses in models/contrastive.py against
procyon_tpu's, values and gradients, on the same numpy inputs in f32: the
in-batch InfoNCE (with a padding mask, conflict ids and a host conflict
mask), the explicit-negative InfoNCE, the max-margin loss and the
projection head.

Tolerance 1e-5 (abs and rel): the same f32 functions, sums in another
order. The learnable temperature's gradient is taken through log_temp, as
the train step takes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.models import contrastive as jcon
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import contrastive as tcon
from torch_cpu_common import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
N, D, K = 6, 8, 3


def _inputs(seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((N, D)).astype(np.float32)
    t = rng.standard_normal((N, D)).astype(np.float32)
    neg = rng.standard_normal((N, K, D)).astype(np.float32)
    return s, t, neg, np.float32(np.log(0.07))


def _torch_grads(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return out.detach(), [t.grad for t in ts]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["plain", "valid", "ids", "mask_and_ids",
                                  "asymmetric"])
def test_info_nce_in_batch_gradients(case):
    s, t, _, lt = _inputs(1)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    ids = np.array([3, 5, 3, 7, 5, 9], np.int32)
    mask = np.ones((N, N), np.float32)
    mask[0, 4] = mask[4, 1] = 0.0
    kw = {"plain": {}, "valid": dict(valid=valid), "asymmetric": {},
          "ids": dict(valid=valid, conflict_ids=ids),
          "mask_and_ids": dict(conflict_mask=mask, conflict_ids=ids)}[case]
    symmetric = case != "asymmetric"

    def jloss(s_, t_, lt_):
        return jcon.info_nce_in_batch(
            {"log_temp": lt_}, jcon.InfoNCEConfig(symmetric=symmetric), s_,
            t_, **{k: jnp.asarray(v) for k, v in kw.items()})[0]

    want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(s, t, lt)
    got, grads = _torch_grads(
        lambda s_, t_, lt_: tcon.info_nce_in_batch(
            {"log_temp": lt_}, tcon.InfoNCEConfig(symmetric=symmetric), s_,
            t_, **{k: torch.from_numpy(v) for k, v in kw.items()})[0],
        s, t, lt)
    _close(got, want[0])
    for g, w in zip(grads, want[1]):
        _close(g, w)


def test_info_nce_explicit_gradients():
    s, t, neg, lt = _inputs(2)
    valid = np.array([1, 0, 1, 1, 1, 1], bool)
    cfg_j, cfg_t = jcon.InfoNCEConfig(), tcon.InfoNCEConfig()
    want = jax.jit(jax.value_and_grad(
        lambda a, b, c, d: jcon.info_nce_explicit(
            {"log_temp": d}, cfg_j, a, b, c, valid=jnp.asarray(valid))[0],
        argnums=(0, 1, 2, 3)))(s, t, neg, lt)
    got, grads = _torch_grads(
        lambda a, b, c, d: tcon.info_nce_explicit(
            {"log_temp": d}, cfg_t, a, b, c,
            valid=torch.from_numpy(valid))[0], s, t, neg, lt)
    _close(got, want[0])
    for g, w in zip(grads, want[1]):
        _close(g, w)


def test_max_margin_loss_gradients():
    s, t, neg, _ = _inputs(3)
    want = jax.jit(jax.value_and_grad(
        lambda a, b, c: jcon.max_margin_loss(a, b, c, margin=0.5),
        argnums=(0, 1, 2)))(s, t, neg)
    got, grads = _torch_grads(
        lambda a, b, c: tcon.max_margin_loss(a, b, c, margin=0.5), s, t, neg)
    assert float(got) > 0                      # some hinges are active
    _close(got, want[0])
    for g, w in zip(grads, want[1]):
        _close(g, w)


def test_projection_head_values_and_gradients():
    """The port's head (its own seeded init) bridged to JAX: the same
    output, and the same gradients for every leaf and for x."""
    tp = tcon.projection_head_init(0, D, 5, device="cpu")
    tp["fc_b"] = torch.linspace(-0.2, 0.3, 5)     # nonzero, to be read
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
    x = np.random.default_rng(4).standard_normal((4, D)).astype(np.float32)
    cot = np.random.default_rng(5).standard_normal((4, 5)).astype(np.float32)

    def jloss(p, x_):
        return jnp.sum(jcon.projection_head_apply(p, x_) * cot)

    (jv, (jg, jgx)) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, x)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = tcon.projection_head_apply(leaves, xt)
    _close(out.detach(), jax.jit(jcon.projection_head_apply)(jp, x))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, jgx)
    for k in tp:
        _close(leaves[k].grad, jg[k])
    j0 = jcon.projection_head_init(jax.random.PRNGKey(0), D, 5)
    assert {k: v.shape for k, v in j0.items()} == {
        k: tuple(v.shape) for k, v in tp.items()}


def test_cross_device_batch_raises():
    """Where the JAX package fails too: axis_name outside any process
    group (JAX: an unbound axis name), and a local conflict_mask with
    axis_name."""
    s, t, _, lt = _inputs(6)
    p = {"log_temp": torch.tensor(lt)}
    with pytest.raises(ValueError, match="outside any process group"):
        tcon.info_nce_in_batch(p, tcon.InfoNCEConfig(), torch.from_numpy(s),
                               torch.from_numpy(t), axis_name="data")
    with pytest.raises(ValueError, match="conflict_ids instead"):
        tcon.info_nce_in_batch(p, tcon.InfoNCEConfig(), torch.from_numpy(s),
                               torch.from_numpy(t), axis_name="data",
                               conflict_mask=torch.ones(6, 6))


def test_cross_device_batch_on_one_rank():
    """axis_name over a one-rank gloo group in this process: the gathered
    batch is the local one, and the loss, metrics and gradients are the
    JAX package's in-batch InfoNCE with conflict ids (several ranks:
    tests/test_torch_parallel_train.py)."""
    import torch.distributed as dist
    from torch_dist_common import free_port
    s, t, _, lt = _inputs(6)
    ids = np.array([0, 1, 2, 1, 3, 4])
    want, wm = jcon.info_nce_in_batch(
        {"log_temp": jnp.asarray(lt)}, jcon.InfoNCEConfig(),
        jnp.asarray(s), jnp.asarray(t), conflict_ids=jnp.asarray(ids))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        st = torch.from_numpy(s).requires_grad_(True)
        got, gm = tcon.info_nce_in_batch(
            {"log_temp": torch.tensor(lt)}, tcon.InfoNCEConfig(), st,
            torch.from_numpy(t), conflict_ids=torch.from_numpy(ids),
            axis_name=dist.group.WORLD)
        got.backward()
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **TOL)
    jg = jax.grad(lambda x: jcon.info_nce_in_batch(
        {"log_temp": jnp.asarray(lt)}, jcon.InfoNCEConfig(), x,
        jnp.asarray(t), conflict_ids=jnp.asarray(ids))[0])(jnp.asarray(s))
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg), **TOL)
