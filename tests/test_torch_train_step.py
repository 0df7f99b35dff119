"""procyon_tpu_torch's train steps (training/train_step.py,
training/combined_step.py, training/optimizer.py) against procyon_tpu's on
the CPU in f32: three steps from the same parameters on the same collator
batches, then the losses, the metrics and every parameter compared; model,
batches and states from tests/torch_train_common.py.

Both sides run the decoder with attn_backend="ref" (remat on in the
port): Adam divides by sqrt(v) + eps, so an element whose clipped gradient
is within a few eps (1e-8) of zero moves with a slope of lr / eps in it,
and a gradient that is mathematically 0 (a saturated head) is rounding
noise of a different size in the flash backward's formulation (delta from
the forward's output, p against its lse) than in autodiff of the
reference. tests/test_torch_train_grads.py holds the port's flash Function
to JAX's gradients directly, where no such amplification happens. The
first update has lr 0 (linear warm-up of one step), the second and third
the groups' own rates; gradients above the clip norm are clipped per
group.

Tolerances: losses and metrics 1e-4 (abs and rel; the same f32 function
with sums in another order). Parameters 5e-5 absolute: the two updates
with lr > 0 move an element by up to 2e-3 (projectors 4e-3), and where its
clipped gradient is near eps, Adam's slope lr / eps turns the gradients'
f32 sum-order noise into a few 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.lora as jlora
from procyon_tpu.training import combined_step as jcs
from procyon_tpu.training import train_step as jts
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import lora as tlora
from procyon_tpu_torch.training import combined_step as tcs
from procyon_tpu_torch.training import train_step as tts
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_train_common import (
    TOL, STEPS, jax_batch, compare_trees, states, check_metrics, make_setup)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("task,mode", [
    ("qa", "full"), ("caption", "qlora"), ("retrieval", "full"),
    ("retrieval", "qlora")])
def test_three_steps_match_reference(setup, task, mode):
    jcfg, tcfg, params, batches = setup
    jstate, tstate, jo, to = states(jcfg, params, mode)
    frozen = mode == "qlora"
    jstep = jts.make_train_step(jcfg, jo, task, donate=False,
                                frozen_base=frozen)
    tstep = tts.make_train_step(tcfg, to, task, frozen_base=frozen)
    jb = jax_batch(batches[task])
    tb = tts.batch_to_device(batches[task], "cpu")
    before = bridge.to_numpy(tstate.get("frozen", {}))
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        check_metrics(tm, jm)
    assert tstate["step"] == int(jstate["step"]) == STEPS
    assert tstate["opt_state"]["count"] == STEPS
    compare_trees(bridge.to_numpy(tstate["params"]), jstate["params"])
    if frozen:   # int8 leaves and the rest of the base stay as they were
        compare_trees(bridge.to_numpy(tstate["frozen"]), jstate["frozen"])
        compare_trees(bridge.to_numpy(tstate["frozen"]), before)


def test_accumulation_matches_reference(setup):
    """accumulation_steps=2: two micro-batches (the qa batch and the same
    rows reversed), grads summed in f32 and halved, one update."""
    jcfg, tcfg, params, batches = setup
    jstate, tstate, jo, to = states(jcfg, params, "full")
    b = batches["qa"]
    flipped = {k: (v[::-1].copy() if isinstance(v, np.ndarray) and v.ndim
                   and v.shape[0] == b["input_ids"].shape[0] else v)
               for k, v in b.items() if k != "reference_indices"}
    stacked = tts.stack_microbatches([b, flipped])
    jstep = jts.make_train_step(jcfg, jo, "qa", donate=False,
                                accumulation_steps=2)
    tstep = tts.make_train_step(tcfg, to, "qa", accumulation_steps=2)
    jb = {k: jnp.asarray(v) for k, v in stacked.items()}
    tb = tts.batch_to_device(stacked, "cpu")
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        check_metrics(tm, jm)
    compare_trees(bridge.to_numpy(tstate["params"]), jstate["params"])


def test_combined_joint_expert_step_matches_reference(setup):
    """make_combined_step(expert_override=3, frozen_base=True) over qa +
    retrieval: the joint phase on an int8 base; expert 3's banks move and
    experts 0-2 only by weight decay (their gradient is 0)."""
    jcfg, tcfg, params, batches = setup
    jstate, tstate, jo, to = states(jcfg, params, "qlora")
    jstep = jcs.make_combined_step(jcfg, jo, donate=False, expert_override=3,
                                   frozen_base=True)
    tstep = tcs.make_combined_step(tcfg, to, expert_override=3,
                                   frozen_base=True)
    jb = {t: jax_batch(batches[t]) for t in ("qa", "retrieval")}
    tb = {t: tts.batch_to_device(batches[t], "cpu")
          for t in ("qa", "retrieval")}
    a0 = tstate["params"]["llama"]["layers"]["lora_wq"]["A"].clone()
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        check_metrics(tm, jm)
    compare_trees(bridge.to_numpy(tstate["params"]), jstate["params"])
    a3 = tstate["params"]["llama"]["layers"]["lora_wq"]["A"]
    moved = (a3 - a0).abs().amax(dim=(0, 2, 3))       # per expert
    assert moved[3] > 10 * moved[:3].max()


def test_gradients_reach_only_the_chosen_expert():
    """lora.apply with a host int expert: the gradient lands on A[e] and
    B[e] alone."""
    cfg = tlora.LoRAConfig(rank=2, alpha=4.0, num_experts=3,
                           dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    p = {"A": torch.randn((3, 5, 2), generator=g, requires_grad=True),
         "B": torch.randn((3, 2, 4), generator=g, requires_grad=True)}
    x = torch.randn((2, 5), generator=g)
    tlora.apply(p, cfg, x, torch.zeros(2, 4), expert_idx=1).sum().backward()
    for name in ("A", "B"):
        norms = p[name].grad.flatten(1).norm(dim=1)
        assert norms[1] > 0 and norms[0] == 0 and norms[2] == 0


def test_router_losses_match_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((10, 4)).astype(np.float32)
    assign = logits.argmax(-1)
    want = jlora.top1_router_losses(jnp.asarray(logits), jnp.asarray(assign),
                                    4)
    got = tlora.top1_router_losses(torch.from_numpy(logits),
                                   torch.from_numpy(assign), 4)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL)
