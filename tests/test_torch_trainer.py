"""procyon_tpu_torch's trainer loop, checkpoints and run_pretrain CLI on the
CPU: the synthetic run (run_pretrain --synthetic true --device cpu: the
tiny model in f32, the synthetic store, the default go/process mix with
its qa, retrieval and caption streams) driven for a few global steps.

Checks: skip frequencies, LoRA phase training (experts 0-2, then the joint
expert-3 update), save -> resume -> continue equal to the uninterrupted run
(bit for bit: the same f32 operations on the same batches in the same
order), pruning that keeps the best checkpoint, the CLI's exit and JSON
line, the one-card refusals, and config.py against procyon_tpu's on the
repository's YAML config.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from procyon_tpu import config as jconfig
from procyon_tpu_torch import config as tconfig
from procyon_tpu_torch.scripts import run_pretrain
from procyon_tpu_torch.training import checkpointing
from procyon_tpu_torch.training import optimizer as topt
from procyon_tpu_torch.training.train_step import batch_to_device
from procyon_tpu_torch.training.trainer import Trainer
from torch_cpu_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--synthetic", "true", "--device", "cpu", "--log_steps", "1",
        "--warmup_steps", "1", "--qa_batch_size", "2",
        "--retrieval_batch_size", "2", "--caption_batch_size", "2"]


def _trainer(tmp_path, *extra):
    run = run_pretrain.setup(BASE + ["--output_dir", str(tmp_path),
                                     *extra])
    return Trainer(cfg=run["ucfg"], params=run["params"],
                   optimizer=run["optimizer"], loop=run["loop"],
                   task_streams=run["streams"], weights=run["weights"],
                   stream_states=run["stream_states"],
                   to_device=lambda b: batch_to_device(b, "cpu"))


def _final_state(out_dir):
    return torch.load(os.path.join(checkpointing.latest_checkpoint(out_dir),
                                   checkpointing.STATE_FILE),
                      weights_only=True)


def test_skip_frequencies(tmp_path):
    trainer = _trainer(tmp_path, "--max_steps", "4", "--save_steps", "0",
                       "--retrieval_skip_frequency", "2",
                       "--caption_skip_frequency", "3")
    trainer.train()
    assert trainer.progress == {"qa": 4, "retrieval": 2, "caption": 2}
    assert trainer.state["step"] == 8
    assert trainer.state["opt_state"]["count"] == 8
    assert checkpointing.list_checkpoints(str(tmp_path)) == [4]


def test_lora_phase_training(tmp_path):
    """Per global step qa on expert 0 and retrieval on expert 1 (no mlm
    stream without the ESM2 tower), each its own update, then the joint
    update over every stream on expert 3: expert 2 gets gradients from no
    phase and moves by weight decay alone."""
    trainer = _trainer(tmp_path, "--max_steps", "2", "--save_steps", "0",
                       "--use_lora", "true", "--lora_num_experts", "4",
                       "--lora_phase_training", "true")
    a0 = trainer.state["params"]["llama"]["layers"]["lora_wq"]["A"].clone()
    b0 = trainer.state["params"]["llama"]["layers"]["lora_wq"]["B"].clone()
    trainer.train()
    assert set(trainer.steps) == {"qa", "retrieval"}
    assert trainer.progress == {"qa": 2, "retrieval": 2, "caption": 0}
    assert trainer.state["step"] == 6          # 2 x (qa, retrieval, joint)
    bank = trainer.state["params"]["llama"]["layers"]["lora_wq"]
    # B starts at 0, so the first updates move B; A follows once B != 0
    moved_b = (bank["B"] - b0).abs().amax(dim=(0, 2, 3))
    moved_a = (bank["A"] - a0).abs().amax(dim=(0, 2, 3))
    assert (moved_b[[0, 1, 3]] > 1e-5).all()
    assert moved_b[2] == 0                      # B = 0 decays to 0
    # six updates of weight decay alone (lr 1e-4, decay 1e-3), plus f32
    # rounding of the products
    assert moved_a[2] <= 6 * 1e-4 * 1e-3 * a0[:, 2].abs().max()
    assert (moved_a[[0, 1, 3]] > 10 * moved_a[2]).all()


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """run_pretrain.main to step 4; and the same run cut after step 2 (its
    schedule still the 4-step one), then resumed by run_pretrain.main in a
    fresh setup (streams rebuilt at the saved position, the prefetching
    pipeline on) and run to step 4: the same parameters and moments, bit
    for bit."""
    common = BASE + ["--save_steps", "2", "--prefetch_depth", "2",
                     "--max_steps", "4"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert run_pretrain.main(common + ["--output_dir", a]) == 0
    cut = _trainer(b, *common[len(BASE):])
    cut.loop = dataclasses.replace(cut.loop, max_steps=2)
    cut.train()
    assert checkpointing.list_checkpoints(b) == [2]
    assert run_pretrain.main(common + ["--output_dir", b,
                                       "--resume", "true"]) == 0
    sa, sb = _final_state(a), _final_state(b)
    assert sa["step"] == sb["step"] == 12
    for tree in ("params", "opt_state"):
        items_a = list(topt.tree_items(sa[tree]))
        items_b = list(topt.tree_items(sb[tree]))
        assert [p for p, _ in items_a] == [p for p, _ in items_b]
        for (path, x), (_, y) in zip(items_a, items_b):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), path
    ta = checkpointing.load_training_state(checkpointing.latest_checkpoint(a))
    tb = checkpointing.load_training_state(checkpointing.latest_checkpoint(b))
    assert ta == tb and ta["global_step"] == 4


def test_prune_keeps_the_best(tmp_path):
    base = str(tmp_path)
    state = {"params": {"w": torch.ones(3)}, "step": 0}
    for step in range(1, 4):
        checkpointing.save_checkpoint(base, step, state)
    checkpointing.mark_best(base, 1)
    for step in range(4, 7):
        checkpointing.save_checkpoint(base, step, state, keep_last=2)
    assert checkpointing.list_checkpoints(base) == [1, 5, 6]
    assert checkpointing.best_checkpoint_step(base) == 1
    like = {"params": {"w": torch.zeros(3, dtype=torch.float64)}, "step": 9}
    back = checkpointing.restore_checkpoint(
        checkpointing.checkpoint_dir(base, 1), like)
    assert back["params"]["w"].dtype == torch.float64 and back["step"] == 0
    with pytest.raises(ValueError, match="differs"):
        checkpointing.restore_checkpoint(
            checkpointing.checkpoint_dir(base, 1), {"params": {}, "step": 0})


def test_run_pretrain_cli_writes_a_checkpoint(tmp_path):
    out = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "procyon_tpu_torch.scripts.run_pretrain",
         *BASE, "--max_steps", "3", "--output_dir", out],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last == {"final_step": 3, "output_dir": out}
    assert checkpointing.list_checkpoints(out) == [3]
    assert os.path.exists(os.path.join(out, "metrics.jsonl"))


@pytest.mark.parametrize("flags,error,match", [
    (["--mesh_fsdp", "2"], AssertionError, "devices"),
    (["--dist_num_processes", "2"], ValueError, "coordinator"),
])
def test_run_pretrain_refuses_what_one_card_cannot_run(tmp_path, flags,
                                                       error, match):
    """One process cannot lay out a mesh of two ranks (the JAX package's
    MeshConfig.resolve refuses it too), nor join a group of two without a
    coordinator; several ranks run in tests/test_torch_parallel_*.py."""
    with pytest.raises(error, match=match):
        run_pretrain.setup(BASE + ["--output_dir", str(tmp_path), *flags])


def test_config_matches_reference_on_the_yaml():
    """parse_all + load_yaml_into on configs/llama3-full.yml give the
    reference's arguments, and build_*_config its model, optimizer and
    loop settings (dtypes as torch dtypes)."""
    argv = ["--from_yaml", os.path.join(ROOT, "configs", "llama3-full.yml")]
    t_args, j_args = tconfig.parse_all(argv), jconfig.parse_all(argv)
    for t, j in zip(t_args, j_args):
        jd = dataclasses.asdict(j)
        td = {k: v for k, v in dataclasses.asdict(t).items() if k in jd}
        assert td == jd
    tm = tconfig.build_model_config(t_args[2], t_args[1])
    jm = jconfig.build_model_config(j_args[2], j_args[1])
    for f in ("dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
              "intermediate", "remat"):
        assert getattr(tm.llama, f) == getattr(jm.llama, f), f
    assert tm.llama.dtype == torch.bfloat16
    assert (tm.protein_embed_dim, tm.retrieval_dim) == (
        jm.protein_embed_dim, jm.retrieval_dim)
    assert dataclasses.asdict(tconfig.build_optimizer_config(t_args[0])) \
        == dataclasses.asdict(jconfig.build_optimizer_config(j_args[0]))
    tl = dataclasses.asdict(tconfig.build_loop_config(t_args[0]))
    jl = dataclasses.asdict(jconfig.build_loop_config(j_args[0]))
    assert {k: v for k, v in tl.items() if k in jl} == jl
