"""procyon_tpu_torch's trainer with a live encoder against procyon_tpu's on
the CPU in f32: LoRA phase training (qa on expert 0, retrieval on 1, mlm on
2, each its own update, then the joint update over every task on 3) with
(Mo)LoRA banks on both towers, the proteins encoded live; the clamp case
(an encoder of one expert under a decoder of four); the joint phase's MLM
expert (a departure, ROADMAP.md section 3); and run_pretrain --synthetic
with the live-encoder flags, whose checkpoint loads as a model with the
encoder's LoRAConfig and lora_targets and resumes.

Both trainers get the same batches in the same order (the reference's
collators with use_protein_tokens, the port's MLM stream) and the same
frozen-mask optimizer (freeze_fn of the run's ModelArgs). Tolerances: the
logged metrics 1e-4 (abs and rel; grad_norm aside, which the reference
takes over the frozen leaves' gradients too, and contrastive_acc, an
argmax over near ties here), the parameters after two global steps
(eight updates) 1e-4 absolute: Adam's lr / eps slope turns gradients near
zero into that much (tests/torch_train_common.py).
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu import config as jconfig
from procyon_tpu.data import collators as jC
from procyon_tpu.data import datasets as jD
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu.training import combined_step as jcs
from procyon_tpu.training import optimizer as jopt
from procyon_tpu.training import train_step as jts
from procyon_tpu.training import trainer as jtrainer
from procyon_tpu_torch import bridge
from procyon_tpu_torch import config as tconfig
from procyon_tpu_torch.data import data_config as tdc
from procyon_tpu_torch.data import datasets as tD
from procyon_tpu_torch.models import checkpoint_io
from procyon_tpu_torch.scripts import run_pretrain
from procyon_tpu_torch.training import checkpointing
from procyon_tpu_torch.training import optimizer as topt
from procyon_tpu_torch.training import trainer as ttrainer
from procyon_tpu_torch.training.train_step import batch_to_device
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_esm_common import jax_lora, live_models

OPT = dict(lr=1e-3, projector_lr=2e-3, warmup_steps=1, total_steps=8,
           schedule="cosine", grad_clip=1.0)
MARGS = dict(use_aaseq_embeddings=False, use_lora=True, use_prot_lora=True)
METRIC_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_ATOL = 1e-4


def _batches(jcfg, n):
    """n qa, retrieval and mlm batches (numpy), proteins as token rows."""
    store = jD.SyntheticStore(n_proteins=32, embed_dim=8, min_len=10,
                              max_len=40)
    tok = jload_tokenizer(vocab_size=jcfg.llama.vocab_size)
    lib = jinstruct.TaskLibrary()
    ccfg = jC.CollatorConfig(max_text_len=192, protein_embed_dim=8,
                             use_protein_tokens=True, max_protein_len=48,
                             max_protein_rows=8)
    rng = np.random.default_rng(0)
    out = {"qa": [], "retrieval": []}
    for _ in range(n):
        for kind, coll_cls in (("qa", jC.QACollator),
                               ("retrieval", jC.RetrievalCollator)):
            task = lib.get(f"disgenet_all_{kind}")
            prompt = jinstruct.get_prompt(task, num_examples=1)
            # distinct proteins and texts: a repeated one ties scores
            ids = np.stack([rng.permutation(32)[:3],
                            rng.permutation(32)[:3]], 1)
            samples = [(int(a), int(b), bool(i % 2)) for i, (a, b) in
                       enumerate(ids)] if kind == "qa" else \
                [(int(a), int(b)) for a, b in ids]
            out[kind].append(coll_cls(ccfg, tok, store, task)(samples,
                                                              prompt))
    mlm = tdc.build_mlm_stream(tD.SyntheticStore(n_proteins=32, min_len=10,
                                                 max_len=40),
                               batch_size=3, n_proteins=32,
                               max_protein_len=40, seed=1)
    out["mlm"] = [mlm() for _ in range(n)]
    return out


def _streams(batches, convert):
    def make(seq):
        it = iter(seq)
        return lambda: convert(next(it))
    return {k: make(v) for k, v in batches.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()
            if k != "reference_indices" and isinstance(v, np.ndarray)}


def _run_both(tmp_path, jcfg, tcfg, params, steps, patch_joint_mlm):
    """Both trainers for `steps` global steps under lora_phase_training;
    returns their final parameters and logged metrics. (The reference's
    steps donate their state, so the port's copy is taken first.)"""
    batches = _batches(jcfg, steps * 2)
    tparams = bridge.to_torch(bridge.to_numpy(params))
    # each global step takes one batch a phase and one a task for the
    # joint phase: the same order in both packages
    jm = jconfig.ModelArgs(**MARGS)
    tm = tconfig.ModelArgs(**MARGS)
    jo = jopt.build_frozen_mask_optimizer(jopt.OptimizerConfig(**OPT),
                                          params, jconfig.freeze_fn(jm))
    to = topt.build_frozen_mask_optimizer(topt.OptimizerConfig(**OPT),
                                          tconfig.freeze_fn(tm))
    loop = dict(max_steps=steps, log_steps=1, save_steps=0,
                lora_phase_training=True)
    if patch_joint_mlm:
        # the reference's joint phase runs the MLM loss on expert 0 (it
        # passes no expert); the port runs it on the joint expert, 3
        shim = types.SimpleNamespace(**vars(jts))
        shim.mlm_loss_fn = lambda *a, **kw: jts.mlm_loss_fn(
            *a, lora_expert=3 % jts.lora_num_experts(jcfg), **kw)
        patch = pytest.MonkeyPatch()
        patch.setattr(jcs, "ts", shim)
    try:
        jt = jtrainer.Trainer(
            cfg=jcfg, params=params, optimizer=jo,
            loop=jtrainer.TrainLoopConfig(output_dir=str(tmp_path / "j"),
                                          **loop),
            task_streams=_streams(batches, _jax_batch))
        jt.train()
    finally:
        if patch_joint_mlm:
            patch.undo()
    tt = ttrainer.Trainer(
        cfg=tcfg, params=tparams, optimizer=to,
        loop=ttrainer.TrainLoopConfig(output_dir=str(tmp_path / "t"),
                                      **loop),
        task_streams=_streams(batches, lambda b: batch_to_device(b, "cpu")))
    tt.train()
    assert set(tt.steps) == set(jt.steps) == {"qa", "retrieval", "mlm"}
    assert tt.state["step"] == int(jt.state["step"]) == 4 * steps

    def logged(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]
    return (jt.state["params"], tt.state["params"],
            logged(tmp_path / "j"), logged(tmp_path / "t"))


def _compare(jp, tp, jlog, tlog):
    assert len(jlog) == len(tlog)
    for a, b in zip(jlog, tlog):
        # grad_norm differs by definition under a freeze mask: the
        # reference's counts the gradients of the frozen leaves too (its
        # step differentiates the whole tree), the port's the trained ones.
        # contrastive_acc is an argmax over targets whose scores agree to
        # 1e-6 (the tiny random encoder's pooled proteins are nearly
        # parallel): a tie either way; the scores are held by the loss and
        # logits_pos
        keys = [k for k in a if k not in ("time", "steps_per_sec",
                                          "global_step")
                and not k.endswith(("grad_norm", "contrastive_acc"))]
        assert keys and set(keys) <= set(b), sorted(set(keys) - set(b))
        for k in keys:
            np.testing.assert_allclose(b[k], a[k], **METRIC_TOL, err_msg=k)
    flat_t = dict(topt.tree_items(bridge.to_numpy(tp)))
    flat_j = dict(topt.tree_items(jax_tree_numpy(jp)))
    assert set(flat_t) == set(flat_j)
    for k, w in flat_j.items():
        np.testing.assert_allclose(flat_t[k], w, atol=PARAM_ATOL, rtol=0,
                                   err_msg="/".join(k))


def jax_tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_tree_numpy(v) for v in tree)
    return np.asarray(tree)


def test_lora_phase_training_with_encoder_banks_matches_reference(tmp_path):
    """Two global steps with 4-expert banks on both towers and the
    encoder's prefix and adapter frozen out (use_prot_lora alone)."""
    jcfg, tcfg, params = live_models(jax_lora(num_experts=4),
                                     llama_lora=jax_lora(num_experts=4))
    b0 = np.array(params["esm"]["layers"]["lora_w1"]["B"])
    jp, tp, jlog, tlog = _run_both(tmp_path, jcfg, tcfg, params, 2,
                                   patch_joint_mlm=True)
    _compare(jp, tp, jlog, tlog)
    assert {"mlm/mlm_loss", "joint/mlm/mlm_loss", "joint/qa/lm_loss",
            "retrieval/retrieval_loss"} <= set(tlog[-1])
    # each phase moved its own encoder expert: B of all four changed
    b = tp["esm"]["layers"]["lora_w1"]["B"].numpy()
    moved = np.abs(b - b0).max(axis=(0, 2, 3))
    assert (moved > 1e-6).all(), moved


def test_joint_phase_clamps_a_smaller_encoder_bank(tmp_path):
    """An encoder of one expert under a decoder of four: the retrieval,
    mlm and joint phases read the encoder's expert 0 through an index past
    its bank, without training it (JAX's clipped gather and its dropped
    gradient); the losses and parameters are the reference's. The
    reference's joint MLM loss is put on the joint expert, as the port's
    (on expert 0 it would train the encoder's bank in the joint phase)."""
    jcfg, tcfg, params = live_models(jax_lora(num_experts=1),
                                     llama_lora=jax_lora(num_experts=4))
    jp, tp, jlog, tlog = _run_both(tmp_path, jcfg, tcfg, params, 1,
                                   patch_joint_mlm=True)
    _compare(jp, tp, jlog, tlog)
    assert "joint/mlm/mlm_loss" in tlog[-1]
    assert tlog[-1]["mlm/grad_norm"] == 0.0   # the MLM phase reads expert 2


def test_joint_phase_runs_the_mlm_loss_on_the_joint_expert():
    """The departure: one joint step over an MLM batch alone moves the
    encoder's expert 3 in the port, its expert 0 in the reference (whose
    combined step passes no expert to the MLM loss)."""
    jcfg, tcfg, params = live_models(jax_lora(num_experts=4),
                                     llama_lora=jax_lora(num_experts=4))
    batch = _batches(jcfg, 1)["mlm"][0]
    pred = jts.lora_trainable_predicate
    trainable, _ = jts.partition_params(params, pred)
    jo = jopt.build_optimizer(jopt.OptimizerConfig(**OPT), trainable)
    jstate = jts.init_train_state(params, jo, trainable_predicate=pred)
    to = topt.build_optimizer(topt.OptimizerConfig(**OPT))
    tstate = bridge.train_state_to_torch(jstate)
    b0 = np.array(params["esm"]["layers"]["lora_wq"]["B"])
    from procyon_tpu_torch.training import combined_step as tcs
    for _ in range(2):      # the first update has lr 0 (warm-up)
        jstate, _ = jcs.make_combined_step(
            jcfg, jo, donate=False, expert_override=3, frozen_base=True)(
            jstate, {"mlm": _jax_batch(batch)})
        tstate, _ = tcs.make_combined_step(
            tcfg, to, expert_override=3, frozen_base=True)(
            tstate, {"mlm": batch_to_device(batch, "cpu")})
    jm = np.abs(np.asarray(jstate["params"]["esm"]["layers"]["lora_wq"][
        "B"]) - b0).max(axis=(0, 2, 3))
    tm = np.abs(tstate["params"]["esm"]["layers"]["lora_wq"]["B"].numpy()
                - b0).max(axis=(0, 2, 3))
    assert jm.argmax() == 0 and tm.argmax() == 3
    assert tm[3] > 10 * tm[:3].max() and jm[0] > 10 * jm[1:].max()


LIVE = ["--synthetic", "true", "--device", "cpu", "--log_steps", "1",
        "--warmup_steps", "1", "--qa_batch_size", "2",
        "--retrieval_batch_size", "2", "--caption_batch_size", "2",
        "--use_aaseq_embeddings", "false", "--protein_encoder", "esm2-8m",
        "--use_prot_lora", "true", "--prot_lora_num_experts", "4",
        "--prot_lora_parameters", "attn", "--aaseq_lora_r", "4",
        "--esm_prefix_len", "2", "--aaseq_adapter_rank", "4",
        "--use_lora", "true", "--lora_num_experts", "4",
        "--lora_phase_training", "true", "--mlm_skip_frequency", "1",
        "--mlm_batch_size", "2", "--max_protein_len", "64",
        "--caption_skip_frequency", "0"]


def test_run_pretrain_live_encoder_checkpoint_loads_and_resumes(tmp_path):
    """run_pretrain --synthetic with the live-encoder flags: its
    checkpoint is a model directory whose config keeps the encoder's
    LoRAConfig, lora_targets, prefix and adapter and whose parameters are
    the run's; a run cut after step 1 and resumed ends where the
    uninterrupted one does, bit for bit (the MLM stream's state
    included)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    common = LIVE + ["--save_steps", "1", "--max_steps", "2"]
    assert run_pretrain.main(common + ["--output_dir", a]) == 0
    path = checkpointing.latest_checkpoint(a)
    model, cfg, tok = checkpoint_io.load_model(path, device="cpu")
    run = run_pretrain.setup(common + ["--output_dir", a])
    assert cfg == run["ucfg"]
    esm = cfg.esm
    assert (esm.lora.rank, esm.lora.num_experts, esm.lora_targets,
            esm.prefix_len, esm.adapter_rank) == (4, 4, "attn", 2, 4)
    assert esm.lora.dtype == torch.float32
    assert sorted(k for k in model["esm"]["layers"]
                  if k.startswith("lora_")) == ["lora_wk", "lora_wq",
                                                "lora_wv"]
    state = torch.load(os.path.join(path, checkpointing.STATE_FILE),
                       weights_only=True)
    for k, t in topt.tree_items(state["params"]):
        assert torch.equal(topt.tree_get(model, k), t), k
    tstate = checkpointing.load_training_state(path)
    # a global step draws an MLM batch for its phase and one for the joint
    assert tstate["stream_states"]["mlm"] == {"batches": 4}

    cut = run_pretrain.setup(common + ["--output_dir", b])
    tr = ttrainer.Trainer(
        cfg=cut["ucfg"], params=cut["params"], optimizer=cut["optimizer"],
        loop=cut["loop"], task_streams=cut["streams"],
        weights=cut["weights"], stream_states=cut["stream_states"],
        to_device=lambda x: batch_to_device(x, "cpu"))
    tr.loop = tr.loop.__class__(**{**tr.loop.__dict__, "max_steps": 1})
    tr.train()
    assert run_pretrain.main(common + ["--output_dir", b,
                                       "--resume", "true"]) == 0
    sa = torch.load(os.path.join(checkpointing.latest_checkpoint(a),
                                 checkpointing.STATE_FILE), weights_only=True)
    sb = torch.load(os.path.join(checkpointing.latest_checkpoint(b),
                                 checkpointing.STATE_FILE), weights_only=True)
    for (pa, x), (pb, y) in zip(topt.tree_items(sa["params"]),
                                topt.tree_items(sb["params"])):
        assert pa == pb and torch.equal(x, y), pa
