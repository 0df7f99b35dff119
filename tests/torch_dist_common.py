"""Shared by the port's distributed CPU tests
(tests/test_torch_parallel_*.py): gloo process groups over 2-4 spawned
CPU processes, one torch thread each, and the workers they run. This
module imports torch and the port only (the spawned processes never load
JAX); the tests compute their JAX references in the test process.

`run_ranks(worker, world, tmp_path, payload)` saves the payload, starts
`world` processes that each join a gloo group at a free localhost port
and call WORKERS[worker](rank, world, payload), and returns their results
in rank order (each rank's result goes through tmp_path)."""

import os
import socket
import sys
import time
import traceback

import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, worker, tmp, join):
    torch.set_num_threads(1)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    out = os.path.join(tmp, f"out{rank}.pt")
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"),
                             weights_only=False)
        if join:
            import torch.distributed as dist
            dist.init_process_group("gloo",
                                    init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=world, rank=rank)
        result = WORKERS[worker](rank, world, payload)
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise


def run_ranks(worker, world, tmp_path, payload, *, join=True,
              timeout=600):
    """The workers' results in rank order; join=False leaves the process
    group to the worker (initialize_multihost's own tests). A rank that
    raises ends the others; ranks still running after `timeout` seconds
    are killed. Either fails the test with the ranks' errors."""
    tmp = str(tmp_path)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    port = free_port()
    ctx = mp.start_processes(_entry, args=(world, port, worker, tmp, join),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                break
    except (mp.ProcessRaisedException, mp.ProcessExitedException):
        pass        # a rank raised: its error is in its result file
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    got = []
    for r in range(world):
        path = os.path.join(tmp, f"out{r}.pt")
        got.append(torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
    errors = [f"rank {r}:\n{g['error']}" for r, g in enumerate(got)
              if g is not None and not g["ok"]]
    missing = [r for r, g in enumerate(got) if g is None]
    if missing:
        errors.append(f"ranks {missing} left no result")
    assert not errors, "\n".join(errors)
    return [g["result"] for g in got]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------


def _mesh(dims):
    from procyon_tpu_torch import parallel
    return parallel.create_mesh(parallel.MeshConfig(*dims))


def train_step_worker(rank, world, p):
    """One train step (p["task"]: qa / retrieval / caption, or "combined"
    over p["batch"] a dict of task batches) on p["mesh"]; returns the
    metrics, the whole updated params and the whole grads of the step
    (from the update: the moments' first step holds (1 - b1) * g)."""
    from procyon_tpu_torch.parallel import shard_batch
    from procyon_tpu_torch.training import checkpointing
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    from procyon_tpu_torch.training.combined_step import make_combined_step
    mesh = _mesh(p["mesh"])
    opt = topt.build_optimizer(topt.OptimizerConfig(**p["opt"]))
    pred = ts.lora_trainable_predicate if p.get("qlora") else None
    state = ts.init_train_state(p["params"], opt, pred, mesh=mesh,
                                cfg=p["cfg"])
    for k in p.get("fault", ()):
        FAULTS[k](state)

    def local(b):
        return shard_batch(ts.batch_to_device(b, "cpu"), mesh)

    if p["task"] == "combined":
        step = make_combined_step(p["cfg"], opt, frozen_base=bool(pred),
                                  expert_override=p.get("expert"))
        batch = {t: local(b) for t, b in p["batch"].items()}
    else:
        step = ts.make_train_step(p["cfg"], opt, p["task"],
                                  frozen_base=bool(pred))
        batch = local(p["batch"])
    state, m = step(state, batch)
    whole = checkpointing.whole_state(state)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _np(whole["params"]),
            "mu": _np(whole["opt_state"]["mu"])}


def _local_mean(total, count, group):
    """A planted fault: each rank's own mean, then the mean of the ranks'
    means (what averaging per-rank losses gives)."""
    import torch.distributed as dist
    mean = total / count.clamp_min(1)
    if group is None:
        return mean
    out = mean.detach().clone()
    dist.all_reduce(out, group=group)
    return mean + (out / dist.get_world_size(group) - mean).detach()


def _mean_of_means(state):
    from procyon_tpu_torch.parallel import collectives
    collectives.global_mean = _local_mean


FAULTS = {"mean_of_means": _mean_of_means}


def decode_worker(rank, world, p):
    """Prefill + 3 greedy decode steps of a tensor-parallel decoder
    (p["paged"]: through the paged pool, else the dense KV cache); returns
    the [4, B, vocab] logits."""
    from procyon_tpu_torch.inference import kv_pool
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.parallel import shard_params
    mesh = _mesh(p["mesh"])
    cfg = p["cfg"]
    params = shard_params(p["params"], mesh, cfg)
    tokens = torch.from_numpy(p["tokens"])
    B, T = tokens.shape
    outs = []
    with torch.no_grad():
        if p["paged"]:
            pcfg = kv_pool.PagedConfig(
                n_layers=cfg.n_layers,
                n_kv_heads=llama.local_kv_heads(params, cfg, mesh),
                head_dim=cfg.head_dim, page_size=4, n_pages=16,
                max_pages_per_seq=4, slots=B, dtype=cfg.dtype)
            pool = kv_pool.init_pool(pcfg, device="cpu")
            pool["page_table"].copy_(torch.from_numpy(p["page_table"]))
            slots = torch.arange(B)
            logits, _ = llama.paged_forward(params, cfg, pool, pcfg, slots,
                                            tokens=tokens, mesh=mesh)
            outs.append(logits[:, -1])
            for _ in range(3):
                tok = outs[-1].argmax(-1)[:, None]
                logits, _ = llama.paged_forward(params, cfg, pool, pcfg,
                                                slots, tokens=tok, mesh=mesh)
                outs.append(logits[:, -1])
        else:
            cache = llama.init_kv_cache(cfg, B, max_len=T + 8, device="cpu",
                                        params=params, mesh=mesh)
            out = llama.forward(params, cfg, tokens=tokens, kv_cache=cache,
                                mesh=mesh)
            outs.append(out["logits"][:, -1])
            cache = out["kv_cache"]
            for _ in range(3):
                tok = outs[-1].argmax(-1)[:, None]
                pos = torch.full((B, 1), cache["length"], dtype=torch.int32)
                out = llama.forward(params, cfg, tokens=tok, positions=pos,
                                    kv_cache=cache, mesh=mesh)
                outs.append(out["logits"][:, -1])
                cache = out["kv_cache"]
    return {"logits": torch.stack(outs).numpy(),
            "pool_kv": (pool["k"].shape[-1] if p["paged"]
                        else cache["k"].shape[-2])}


SERVING_MODES = {
    "plain": ({}, False),
    "kv8": ({}, True),
    "spec_k2": ({"spec_k": 2}, False),
    "prefix+wave": ({"prefix_cache": True, "prefill_chunk": 4,
                     "prefill_batch": 2}, False),
}


def serving_workload(b, p):
    """The dry run's mixed workload: token requests behind a shared
    prefix and one fused (soft-token) request."""
    rids = [b.submit(list(map(int, q)), max_new=p["max_new"])
            for q in p["prompts"]]
    rids.append(b.submit_fused(p["fused"], max_new=p["max_new"]))
    out = b.run()
    return [out[r] for r in rids]


def serving_pcfg(cfg, quantize_kv, slots=2):
    from procyon_tpu_torch.inference import kv_pool
    return kv_pool.PagedConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, page_size=4, n_pages=32,
        max_pages_per_seq=8, slots=slots, dtype=cfg.dtype,
        quantize_kv=quantize_kv)


def serving_worker(rank, world, p):
    """The ContinuousBatcher on a mesh in each of p["modes"] (p["bits"]:
    on the weights quantize_params gives); returns the tokens, the pool's
    lanes a rank and the prefix-cache hits."""
    from procyon_tpu_torch.inference.serving import ContinuousBatcher
    from procyon_tpu_torch.models import llama
    mesh = _mesh(p["mesh"])
    params = p["params"]
    if p.get("bits"):
        params = llama.quantize_params(params, p["cfg"], bits=p["bits"])
    out = {}
    for name in p["modes"]:
        kw, qkv = SERVING_MODES[name]
        b = ContinuousBatcher(params, p["cfg"],
                              serving_pcfg(p["cfg"], qkv), mesh=mesh,
                              device="cpu", temperature=p.get("temp", 0.0),
                              seed=3, **kw)
        toks = serving_workload(b, p)
        out[name] = {"tokens": toks, "lanes": b.pool["k"].shape[-1],
                     "hits": b.pcache.stats["hit_tokens"] if b.pcache
                     else 0}
    return out


def multihost_worker(rank, world, p):
    """initialize_multihost from the dist_* flags (no group yet), an
    all-reduce over the mesh, and the rank-interleaved mixer batches."""
    import torch.distributed as dist
    from procyon_tpu_torch import parallel
    from procyon_tpu_torch.data import mixing
    idx, count = parallel.initialize_multihost(
        f"127.0.0.1:{p['port']}", world, rank, device="cpu")
    assert (idx, count) == (rank, world), (idx, count)
    again = parallel.initialize_multihost(
        f"127.0.0.1:{p['port']}", world, rank, device="cpu")
    mesh = parallel.create_mesh(parallel.MeshConfig(data=world, fsdp=1))
    x = torch.arange(8.0).reshape(world, -1)[rank].sum()
    total = x.clone()
    dist.all_reduce(total, group=mesh.group("batch"))

    class _DS:
        def __len__(self):
            return 32

    mixer = mixing.TaskMixer({"d": _DS()}, {"d": 4}, seed=0, rank=idx,
                             world_size=count)
    it = mixer.iterate(mixing.MixerState())
    seen = []
    for _ in range(4):
        _, idxs, _ = next(it)
        seen.extend(int(i) for i in idxs)
    dist.destroy_process_group()
    return {"rank": idx, "world": count, "again": again,
            "total": float(total), "indices": sorted(seen),
            "coords": mesh.coords}


def checkpoint_worker(rank, world, p):
    """Two train steps on a mesh, a checkpoint after the first (rank 0
    writes whole leaves); returns the step-2 metrics and whole params."""
    from procyon_tpu_torch.parallel import shard_batch
    from procyon_tpu_torch.training import checkpointing
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    mesh = _mesh(p["mesh"])
    opt = topt.build_optimizer(topt.OptimizerConfig(**p["opt"]))
    state = ts.init_train_state(p["params"], opt, mesh=mesh, cfg=p["cfg"])
    step = ts.make_train_step(p["cfg"], opt, "qa")
    batch = shard_batch(ts.batch_to_device(p["batch"], "cpu"), mesh)
    if p.get("resume"):
        state = checkpointing.restore_checkpoint(p["resume"], state)
    else:
        state, _ = step(state, batch)
        checkpointing.save_checkpoint(p["dir"], 1, state, cfg=p["cfg"])
    state, m = step(state, batch)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _np(checkpointing.whole_state(state)["params"])}


WORKERS = {"train_step": train_step_worker, "decode": decode_worker,
           "serving": serving_worker, "multihost": multihost_worker,
           "checkpoint": checkpoint_worker}
