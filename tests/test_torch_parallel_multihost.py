"""More than one process: parallel.initialize_multihost from the dist_*
flags (the analogue of tests/test_multihost.py, with its single-process
no-op), a checkpoint written by 2 ranks resumed on 1 process and the
reverse, run_pretrain on 2 gloo ranks against 1 process, and the
multi-rank dry run (scripts/dryrun_multichip.py) on 4 CPU ranks."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from procyon_tpu_torch import parallel
from procyon_tpu_torch.models import checkpoint_io, unified
from procyon_tpu_torch.training import checkpointing
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_dist_common import checkpoint_worker, free_port, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant")


def test_two_process_multihost(tmp_path):
    """Two processes join through the flags (no group before), see each
    other in an all-reduce over the mesh, and their rank-interleaved
    mixer batches are disjoint (DistributedSamplerResume semantics)."""
    res = run_ranks("multihost", 2, tmp_path, {"port": free_port()},
                    join=False)
    assert [(r["rank"], r["world"]) for r in res] == [(0, 2), (1, 2)]
    assert all(r["again"] == (r["rank"], 2) for r in res)
    assert all(r["total"] == 28.0 for r in res)
    assert [r["coords"]["data"] for r in res] == [0, 1]
    i0, i1 = set(res[0]["indices"]), set(res[1]["indices"])
    assert i0 and i1 and not (i0 & i1)


def test_initialize_noop_single_process(monkeypatch):
    """One process with no launcher variables: no group is made."""
    import torch.distributed as dist
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_multihost(num_processes=1) == (0, 1)
    assert parallel.initialize_multihost() == (0, 1)
    assert not dist.is_initialized()
    assert parallel.create_mesh().trivial


def _setup():
    cfg = unified.tiny_config(esm=None, protein_embed_dim=16)
    params = unified.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(2)
    B, L = 4, 16
    labels = rng.integers(0, cfg.llama.vocab_size, (B, L)).astype(np.int32)
    labels[:, :5] = -100
    batch = {"input_ids": rng.integers(4, cfg.llama.vocab_size,
                                       (B, L)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(L, dtype=np.int32),
                                          (B, L)).copy(),
             "protein_embeds": rng.standard_normal((3, 16))
             .astype(np.float32),
             "labels": labels}
    return dict(cfg=cfg, params=params, batch=batch, opt=OPT)


@pytest.mark.parametrize("write,read", [((1, 2, 1), (1, 1, 1)),
                                        ((1, 1, 1), (2, 1, 1)),
                                        ((1, 1, 2), (1, 2, 1))])
def test_checkpoint_resumes_on_another_mesh(tmp_path, write, read):
    """Step 1 on `write`'s ranks, a checkpoint of whole leaves (rank 0
    writes), then step 2 resumed from it on `read`'s ranks: the same as
    step 2 on the writer's ranks. The checkpoint loads as a model."""
    p = dict(_setup(), dir=str(tmp_path / "ckpt"))

    def run(mesh, tmp, **kw):
        n = int(np.prod(mesh))
        q = dict(p, mesh=mesh, **kw)
        if n == 1:
            return [checkpoint_worker(0, 1, q)]
        return run_ranks("checkpoint", n, tmp, q)

    (tmp_path / "w").mkdir()
    (tmp_path / "r").mkdir()
    first = run(write, tmp_path / "w")
    path = checkpointing.checkpoint_dir(p["dir"], 1)
    assert checkpointing.list_checkpoints(p["dir"]) == [1]
    second = run(read, tmp_path / "r", resume=path)
    for r in first + second:
        assert r["metrics"] == first[0]["metrics"] or all(
            abs(r["metrics"][k] - v) <= 1e-5 * max(1.0, abs(v))
            for k, v in first[0]["metrics"].items()), r["metrics"]
    for a, b in zip(first[0]["params"]["llama"]["layers"]["attn"]["wq"],
                    second[0]["params"]["llama"]["layers"]["attn"]["wq"]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    params, cfg, _ = checkpoint_io.load_model(path, device="cpu")
    assert params["llama"]["layers"]["attn"]["wq"].shape == \
        p["params"]["llama"]["layers"]["attn"]["wq"].shape
    assert cfg.llama.dim == p["cfg"].llama.dim


BASE = ["--synthetic", "true", "--device", "cpu", "--log_steps", "1",
        "--warmup_steps", "1", "--qa_batch_size", "4",
        "--retrieval_batch_size", "4", "--caption_batch_size", "4",
        "--prefetch_depth", "0", "--max_steps", "3"]


def _losses(out):
    rows = [json.loads(line) for line in
            open(os.path.join(out, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k.endswith("/loss")}
            for r in rows]


def test_run_pretrain_two_ranks_equal_one_process(tmp_path):
    """run_pretrain on 2 gloo ranks (--mesh_fsdp -1: FSDP over both;
    every rank draws the same global batches and keeps its rows) logs the
    one-process run's losses, and rank 0 alone writes the checkpoint."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    one = str(tmp_path / "one")
    subprocess.run([sys.executable, "-m",
                    "procyon_tpu_torch.scripts.run_pretrain", *BASE,
                    "--output_dir", one], cwd=ROOT, env=env, check=True,
                   capture_output=True, timeout=300)
    two = str(tmp_path / "two")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "procyon_tpu_torch.scripts.run_pretrain",
         *BASE, "--output_dir", two, "--mesh_fsdp", "-1",
         "--dist_coordinator", f"127.0.0.1:{port}",
         "--dist_num_processes", "2", "--dist_process_id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    assert json.loads(outs[0][0].strip().splitlines()[-1]) == {
        "final_step": 3, "output_dir": two}
    assert outs[1][0].strip() == ""
    want, got = _losses(one), _losses(two)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and g
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-4 * max(1.0, abs(w[k])), (k, g, w)
    assert checkpointing.list_checkpoints(two) == [3]
    a = torch.load(os.path.join(one, "checkpoint-3", "state.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(two, "checkpoint-3", "state.pt"),
                   weights_only=True)
    wa = a["params"]["llama"]["layers"]["attn"]["wq"]
    assert b["params"]["llama"]["layers"]["attn"]["wq"].shape == wa.shape


def test_dryrun_multichip_on_four_cpu_ranks():
    """The dry run's three phases on a (1, 2, 2) mesh of 4 gloo ranks,
    each held to one process in the script itself (losses within 1e-4,
    the serving tokens equal)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "procyon_tpu_torch.scripts.dryrun_multichip",
         "--ranks", "4", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    oks = [json.loads(line.split("OK ", 1)[1])
           for line in proc.stdout.splitlines()
           if line.startswith("dryrun_multichip OK")]
    assert sorted(r["rank"] for r in oks) == [0, 1, 2, 3]
    assert oks[0]["mesh"] == {"data": 1, "fsdp": 2, "model": 2}
    for r in oks:
        assert r["multitask"]["loss_err"] <= 1e-4
        assert r["flagship"]["loss_err"] <= 1e-4
        assert set(r["serving"]) == {"plain", "kv8", "spec_k2",
                                     "prefix+wave"}
