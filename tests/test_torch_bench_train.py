"""scripts/bench_train.py of the port against the JAX package on the CPU:
the batch is the reference script's for the same seed (captured from the
reference's own main at a tiny shape), the FLOP count and matmul weights
equal the reference's functions, and one timed step (the QA step, and the
combined QA + retrieval step) gives the reference step's loss and gradient
norm within 1e-4 relative on its parameters, bridged (f32, the reference
attention). Then the CLI's untimed run."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.training.train_step as jts
from procyon_tpu.models import llama as jllama
from procyon_tpu.models import unified as juni
from procyon_tpu.training.combined_step import make_combined_step
from procyon_tpu.training.optimizer import OptimizerConfig, build_optimizer
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.scripts import bench_train
from procyon_tpu_torch.training import train_step as tts
from torch_bench_common import jax_script, last_json
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_eval_common import port_config

JAX_SCRIPT = jax_script("bench_train")
STEP_RTOL = 1e-4


class _Captured(Exception):
    pass


def test_batch_is_the_references(monkeypatch):
    """The reference's main builds its batch inline: run it at a tiny shape
    with its step replaced by one that hands the batch back."""
    def capturing_step(*a, **kw):
        def step(state, batch):
            raise _Captured(batch)
        return step

    monkeypatch.setattr(jts, "make_train_step", capturing_step)
    monkeypatch.setattr(sys, "argv", ["bench_train", "--dim", "128",
                                      "--layers", "1", "--batch", "3",
                                      "--seq", "24"])
    with pytest.raises(_Captured) as got:
        JAX_SCRIPT.main()
    want = got.value.args[0]
    mine = bench_train.train_batch(3, 24, 32000, seed=0)
    assert sorted(mine) == sorted(want)
    for k, v in mine.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("frozen_base,remat", [(True, True), (False, True),
                                               (False, False)])
def test_flops_equal_the_references(frozen_base, remat):
    for seq, cfg in ((2048, tllama.llama3_8b()),
                     (512, tllama.LlamaConfig(
                         vocab_size=32000, dim=1024, n_layers=8, n_heads=8,
                         n_kv_heads=4, intermediate=2752))):
        assert bench_train.matmul_params(cfg) == \
            JAX_SCRIPT.matmul_params(cfg)
        assert bench_train.train_flops_per_token(
            cfg, seq, frozen_base=frozen_base, remat=remat) == \
            JAX_SCRIPT.train_flops_per_token(cfg, seq,
                                             frozen_base=frozen_base,
                                             remat=remat)


@pytest.fixture(scope="module")
def model():
    jcfg = juni.UnifiedConfig(
        llama=jllama.tiny_config(vocab_size=512, attn_backend="ref",
                                 remat=True, max_seq_len=64),
        esm=None, protein_embed_dim=32, token_projector_layers=3,
        token_projector_hidden=48, retrieval_dim=16, dtype=jnp.float32)
    jparams = juni.init_params(jax.random.PRNGKey(6), jcfg)
    tcfg = port_config(jcfg)
    tcfg = dataclasses.replace(tcfg, llama=dataclasses.replace(
        tcfg.llama, remat=True))
    return jcfg, jparams, tcfg


@pytest.mark.parametrize("combined", [False, True])
def test_step_matches_reference(model, combined):
    jcfg, jparams, tcfg = model
    batch = bench_train.train_batch(4, 32, 512, embed_dim=32, seed=2)
    tparams = bridge.to_torch(jparams)
    state, step, _, passes = bench_train.make_step(
        tcfg, tparams, frozen_base=False, combined=combined)
    assert passes == (2 if combined else 1)
    state, m = step(state, tts.batch_to_device(batch, "cpu"))

    ocfg = OptimizerConfig(lr=1e-4, warmup_steps=10, total_steps=1000)
    opt = build_optimizer(ocfg, jparams)
    jstate = jts.init_train_state(jparams, opt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if combined:
        jstep = make_combined_step(jcfg, opt, donate=False,
                                   expert_override=3)
        jstate, jm = jax.jit(jstep)(jstate, {"qa": jb, "retrieval": jb})
    else:
        jstep = jts.make_train_step(jcfg, opt, "qa", donate=False)
        jstate, jm = jax.jit(jstep)(jstate, jb)
    for key in ("loss", "grad_norm"):
        got, want = float(m[key]), float(jm[key])
        assert abs(got - want) <= STEP_RTOL * abs(want), (key, got, want)


def test_cli_runs_untimed_on_the_cpu(capsys):
    res = bench_train.main(["--device", "cpu", "--dim", "128", "--layers",
                            "1", "--batch", "2", "--seq", "16",
                            "--steps_small", "1", "--steps_big", "2",
                            "--combined"])
    line = last_json(capsys)
    assert line == res["line"] and line["timed"] is False
    assert line["metric"] == "train_tokens_per_sec_chip"
    assert line["value"] is None and line["mfu"] is None
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 3
    assert line["model_flops_per_step"] == 2 * 2 * 16 * \
        bench_train.train_flops_per_token(
            bench_train.bench_config(bench_train.parse_args(
                ["--device", "cpu", "--dim", "128", "--layers", "1"])).llama,
            16, frozen_base=False, remat=True)
    assert torch.is_tensor(res["state"]["params"]["llama"]["embed"])
