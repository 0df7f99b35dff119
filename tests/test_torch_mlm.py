"""procyon_tpu_torch's masked-LM task against procyon_tpu's on the CPU in f32:
the encoder's MLM head (`unified.protein_mlm_logits`), `mlm_loss_fn`'s loss
and accuracy and the gradients of the encoder's banks, prefix and adapter,
three MLM train steps, and the MLM stream (`build_mlm_stream`): a batch is
the reference's native encode-and-mask of the proteins it drew, and a
stream rebuilt from its state continues where it stopped.

Tolerances: logits, losses and metrics 1e-5 (abs and rel; one f32 forward
with sums in another order), gradients 1e-4 of each leaf's largest,
parameters after three steps 5e-5 absolute (tests/torch_train_common.py's
reasons: Adam's lr / eps slope near zero gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.unified as juni
from procyon_tpu import native as jnative
from procyon_tpu.training import optimizer as jopt
from procyon_tpu.training import train_step as jts
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data import data_config as tdc
from procyon_tpu_torch.data import datasets as tD
from procyon_tpu_torch.models import unified as tuni
from procyon_tpu_torch.training import optimizer as topt
from procyon_tpu_torch.training import train_step as tts
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_esm_common import (FWD_TOL, assert_grads_close, jax_lora,
                              live_models, set_path, trained)
from torch_train_common import compare_trees

PEFT = ("/lora_", "/prefix/", "/adapter/")


def _peft(path):
    return path.startswith("esm") and any(s in path for s in PEFT)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, params = live_models(jax_lora(num_experts=3), prefix_len=2,
                                     adapter_rank=4)
    store = tD.SyntheticStore(n_proteins=32, embed_dim=8, min_len=20,
                              max_len=60)
    stream = tdc.build_mlm_stream(store, batch_size=4, n_proteins=32,
                                  max_protein_len=40, seed=3)
    batch = stream()
    return jcfg, tcfg, params, batch


@pytest.mark.parametrize("expert", [0, 2])
def test_mlm_logits_loss_and_grads_match_reference(setup, expert):
    jcfg, tcfg, params, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tts.batch_to_device(batch, "cpu")
    want = juni.protein_mlm_logits(params, jcfg, jb["protein_tokens"],
                                   lora_expert=expert)
    tp = bridge.to_torch(params)
    got = tuni.protein_mlm_logits(tp, tcfg, tb["protein_tokens"],
                                  lora_expert=expert)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)

    def jloss(tr):
        p = params
        for k, v in tr.items():
            p = set_path(p, k, v)
        return jts.mlm_loss_fn(p, jcfg, jb, 0.5, lora_expert=expert)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        trained(params, _peft))
    leaves = trained(tp, _peft)
    for t in leaves.values():
        t.requires_grad_(True)
    tl, tm = tts.mlm_loss_fn(tp, tcfg, tb, 0.5, lora_expert=expert)
    grads = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **FWD_TOL)
    assert set(tm) == set(jm) == {"mlm_loss", "mlm_acc"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **FWD_TOL,
                                   err_msg=k)
    assert_grads_close(dict(zip(leaves, grads)), jg)
    assert (batch["mlm_labels"] != -100).sum() > 0


def test_mlm_loss_over_no_masked_residue_is_zero():
    """Labels all -100: loss and accuracy 0 (the denominator clamped to 1),
    as in the reference."""
    jcfg, tcfg, params = live_models(jax_lora(num_experts=2))
    toks = np.full((2, 10), 5, np.int32)
    toks[:, 0], toks[:, -1] = 0, 2
    labels = np.full((2, 10), -100, np.int32)
    tl, tm = tts.mlm_loss_fn(bridge.to_torch(params), tcfg,
                             {"protein_tokens": torch.from_numpy(toks),
                              "mlm_labels": torch.from_numpy(labels)}, 1.0)
    jl, jm = jts.mlm_loss_fn(params, jcfg, {"protein_tokens": toks,
                                            "mlm_labels": labels}, 1.0)
    assert float(tl) == float(jl) == 0.0
    assert float(tm["mlm_acc"]) == float(jm["mlm_acc"]) == 0.0


def test_three_mlm_steps_match_reference(setup):
    """make_train_step(..., "mlm", frozen_base=True) on the encoder's
    banks, prefix and adapter (the projectors and the contrastive
    temperature train too, with no gradient from this loss)."""
    jcfg, tcfg, params, batch = setup
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=8, schedule="cosine",
                grad_clip=1.0)

    def pred(path):
        return _peft(path) or path.startswith(("projectors", "contrastive"))

    trainable, _ = jts.partition_params(params, pred)
    jo = jopt.build_optimizer(jopt.OptimizerConfig(**ocfg), trainable)
    jstate = jts.init_train_state(params, jo, trainable_predicate=pred)
    to = topt.build_optimizer(topt.OptimizerConfig(**ocfg))
    tstate = bridge.train_state_to_torch(jstate)
    jstep = jts.make_train_step(jcfg, jo, "mlm", donate=False,
                                frozen_base=True)
    tstep = tts.make_train_step(tcfg, to, "mlm", frozen_base=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tts.batch_to_device(batch, "cpu")
    frozen = bridge.to_numpy(tstate["frozen"])
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm[k]), float(v), atol=1e-4,
                                       rtol=1e-4, err_msg=k)
    compare_trees(bridge.to_numpy(tstate["params"]), jstate["params"])
    compare_trees(bridge.to_numpy(tstate["frozen"]), frozen)
    # the mlm phase's expert is 2 of the encoder's 3
    bank = tstate["params"]["esm"]["layers"]["lora_wq"]["B"]
    start = torch.from_numpy(np.asarray(params["esm"]["layers"]["lora_wq"][
        "B"]))
    moved = (bank - start).abs().amax(dim=(0, 2, 3))
    assert moved[2] > 10 * moved[:2].max()


class _Spy:
    """A store that records the protein ids a stream asks for."""

    def __init__(self, base):
        self.base, self.asked = base, []

    def protein_sequence(self, i):
        self.asked.append(i)
        return self.base.protein_sequence(i)


def test_stream_batch_is_the_references_encode_and_mask():
    """Batch n of the stream: the proteins it drew, truncated to
    max_protein_len and masked by the reference's native functions with
    seed + n, bit for bit; long proteins are cut."""
    store = _Spy(tD.SyntheticStore(n_proteins=64, min_len=20, max_len=90))
    stream = tdc.build_mlm_stream(store, batch_size=6, n_proteins=64,
                                  max_protein_len=48, seed=11)
    for n in (1, 2):
        store.asked.clear()
        got = stream()
        seqs = [store.base.protein_sequence(i) for i in store.asked]
        assert len(seqs) == 6 and all(0 <= i < 64 for i in store.asked)
        pb = jnative.batch_encode(seqs, max_len=48, long_strategy="truncate")
        masked, labels = jnative.mask_for_mlm(pb.tokens, 11 + n)
        np.testing.assert_array_equal(got["protein_tokens"], masked)
        np.testing.assert_array_equal(got["mlm_labels"], labels)
    assert got["protein_tokens"].shape[1] <= 50


def test_resumed_stream_continues():
    """The state the stream leaves after each batch rebuilds a stream that
    gives the uninterrupted stream's next batches."""
    store = tD.SyntheticStore(n_proteins=64, min_len=20, max_len=90)
    holder = {}
    whole = tdc.build_mlm_stream(store, batch_size=4, n_proteins=64,
                                 max_protein_len=48, seed=5,
                                 state_holder=holder)
    batches = [whole() for _ in range(5)]
    assert holder["mlm"] == {"batches": 5}
    cut_holder = {}
    cut = tdc.build_mlm_stream(store, batch_size=4, n_proteins=64,
                               max_protein_len=48, seed=5,
                               state_holder=cut_holder)
    for _ in range(2):
        cut()
    resumed = tdc.build_mlm_stream(store, batch_size=4, n_proteins=64,
                                   max_protein_len=48, seed=5,
                                   resume_state=dict(cut_holder["mlm"]))
    for want in batches[2:]:
        got = resumed()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    again = tdc.build_mlm_stream(store, batch_size=4, n_proteins=64,
                                 max_protein_len=48, seed=6)()
    assert not np.array_equal(again["protein_tokens"],
                              batches[0]["protein_tokens"])


def test_midtrain_eval_reports_the_mlm_val_loss(setup):
    """build_midtrain_eval with an MLM val stream: mlm/* through the
    generic loop and in its "loss", the reference's numbers."""
    from procyon_tpu.training import evaluation as jev
    from procyon_tpu_torch.training import evaluation as tev
    jcfg, tcfg, params, batch = setup
    store = tD.SyntheticStore(n_proteins=32, min_len=20, max_len=60)

    def stream():
        return tdc.build_mlm_stream(store, batch_size=3, n_proteins=32,
                                    max_protein_len=40, seed=9)

    want = jev.build_midtrain_eval(
        jcfg, val_streams={"mlm": stream()}, n_batches=2,
        to_device=lambda b: {k: jnp.asarray(v) for k, v in b.items()})(
        params)
    got = tev.build_midtrain_eval(tcfg, val_streams={"mlm": stream()},
                                  n_batches=2, device="cpu")(
        bridge.to_torch(params))
    assert set(got) == set(want) == {"mlm/mlm_loss", "mlm/mlm_acc",
                                     "mlm/loss", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **FWD_TOL, err_msg=k)
