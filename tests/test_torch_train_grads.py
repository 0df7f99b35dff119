"""Gradients of procyon_tpu_torch's training losses through its flash
Function (attn_backend None: the autograd Function, whose backward on the
CPU is flash_bwd_ref) with remat on, against jax.value_and_grad of
procyon_tpu's (attn_backend "ref"), on the tiny fusion model and collator
batches of tests/torch_train_common.py: the qa, caption and retrieval
losses over the trainable leaves, and unified.forward's lm_loss_per_row
and retrieval_loss over every parameter.

Tolerance: each element within 5e-4 of its leaf's largest JAX gradient
plus 5e-4 of itself; losses 1e-4. The Function's f32 gradients are about
1.5e-6 (relative to the largest) from float64 on random inputs, against
4e-8 for autodiff of the reference; through two layers and a saturated
head of this tiny model that reaches the embedding's gradient as about
2e-4 of its largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.unified as juni
from procyon_tpu.training import train_step as jts
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import unified as tuni
from procyon_tpu_torch.training import optimizer as topt
from procyon_tpu_torch.training import train_step as tts
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_train_common import (
    TOL, GRAD_SHARE, configs, jax_batch, states, flat, make_setup)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("task,mode", [
    ("qa", "qlora"), ("caption", "full"), ("retrieval", "qlora")])
def test_flash_function_gradients_match_reference(setup, task, mode):
    """The port's loss through its flash Function (attn_backend None: the
    autograd Function, whose backward on the CPU is flash_bwd_ref) with
    remat, differentiated over the trainable leaves, against
    jax.value_and_grad of the JAX loss (attn_backend "ref")."""
    jcfg, _, params, batches = setup
    _, tcfg = configs(attn_backend=None)
    jstate, tstate, _, to = states(jcfg, params, mode)
    frozen = mode == "qlora"
    expert = jts.TASK_LORA_EXPERT[task]
    jfn, tfn = jts._LOSS_FNS[task], tts._LOSS_FNS[task]
    jb = jax_batch(batches[task])
    tb = tts.batch_to_device(batches[task], "cpu")

    def jloss(p):
        full = jts.merge_params(p, jstate["frozen"]) if frozen else p
        return jfn(full, jcfg, jb, 1.0, lora_expert=expert)

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstate["params"])
    tl, _, items, grads = tts.value_and_grad(
        to, tstate, frozen,
        lambda p: tfn(p, tcfg, tb, 1.0, lora_expert=expert))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = dict(flat(jg))
    assert sorted(p for p, _ in items) == sorted(want)
    for (path, _), g in zip(items, grads):
        w = np.asarray(want[path])
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_SHARE,
            atol=GRAD_SHARE * float(np.abs(w).max()), err_msg="/".join(path))


def test_unified_forward_outputs_under_autograd(setup):
    """unified.forward's lm_loss_per_row (weighted per row) and, on the
    retrieval batch, retrieval_loss, differentiated by each package over
    every parameter of the full model: the same gradients (the flash
    Function on the port's side)."""
    jcfg, _, params, batches = setup
    _, tcfg = configs(attn_backend=None)
    for task, key, kw in (("qa", "lm_loss_per_row", {}),
                          ("retrieval", "retrieval_loss",
                           dict(retrieval=True))):
        jb = jax_batch(batches[task])
        tb = tts.batch_to_device(batches[task], "cpu")
        weights = np.linspace(0.5, 1.5, jb["input_ids"].shape[0],
                              dtype=np.float32)

        def jloss(p):
            out = juni.forward(p, jcfg, jb, **kw)[key]
            return jnp.sum(out * weights) if out.ndim else out

        jv, jg = jax.jit(jax.value_and_grad(jloss))(params)
        tp = topt.tree_map(lambda t: t.clone().requires_grad_(),
                           bridge.to_torch(params, device="cpu"))
        items = list(topt.tree_items(tp))
        out = tuni.forward(tp, tcfg, tb, max_position=tb["max_position"],
                           **kw)[key]
        loss = (out * torch.from_numpy(weights)).sum() if out.ndim else out
        grads = torch.autograd.grad(loss, [t for _, t in items],
                                    allow_unused=True)
        np.testing.assert_allclose(float(loss.detach()), float(jv), **TOL)
        want = dict(flat(jg))
        for (path, _), g in zip(items, grads):
            w = np.asarray(want[path])
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(
                g, w, rtol=GRAD_SHARE,
                atol=GRAD_SHARE * float(np.abs(w).max()),
                err_msg=f"{task}: {'/'.join(path)}")
