"""The multi-rank dry run (counterpart of __graft_entry__.dryrun_multichip):
three phases on a (data, fsdp, model) mesh, each held to the same work in
one process on the same rank.

  1. the multi-task step (qa, caption, retrieval with the global
     contrastive batch, the encoder's MLM) through make_combined_step on
     a tiny fusion model with a live ESM2 encoder and task-banked LoRA;
  2. the flagship-shaped step: the llama3-full.yml topology (GQA 4, 3.5x
     FFN, frozen 2560-wide protein tables, struct + drug banks, LoRA r16 x
     4) at reduced depth and vocabulary (and width on the CPU,
     FLAGSHIP_DIM), an accumulating QA step on expert 0 and the joint
     all-task step on expert 3;
  3. tensor-parallel serving: the ContinuousBatcher on the mesh against
     the one-process batcher in four modes (plain, int8 KV, spec_k 2,
     prefix cache with chunked wave prefill), on mixed token and fused
     requests.

On the CPU (f32, the "ref" attention) the losses agree within 1e-4 and
the tokens are equal. On the card (bf16, the kernels) the losses agree
within 2e-2, and the serving phase steps the mesh under the one-process
run's tokens and holds its logits within 5e-2; both ranks' tokens must be
identical.

  python -m procyon_tpu_torch.scripts.dryrun_multichip --ranks 4 \\
      --device cpu
starts the ranks itself (gloo; on the card every rank shares card 0, which
NCCL refuses, so the card also runs gloo). Under torchrun (a process group
already there) every rank runs the phases directly:
  python -m torch.distributed.run --nproc_per_node N \\
      -m procyon_tpu_torch.scripts.dryrun_multichip
Each rank's "dryrun_multichip OK" line with its numbers is printed (by the
parent, in rank order, when it started the ranks); the parent exits
non-zero if any rank failed.
"""

import argparse
import copy
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch

ATOL = {"cpu": 1e-4, "cuda": 2e-2}
SERVING_LOGIT_ATOL = 5e-2
# phase 2's decoder width: Llama-3-8B's on the card; on the CPU an eighth
# with the same topology (GQA 4, 3.5x FFN), where f32 products of the
# full width on four single-threaded ranks would take minutes
FLAGSHIP_DIM = {"cpu": 512, "cuda": 4096}
TIMEOUT_S = 900             # the parent ends ranks still running after


def default_mesh(n: int):
    """The JAX dry run's layout: model 2 and fsdp 2 where they divide."""
    model = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % 4 == 0 else 1
    return (n // (model * fsdp), fsdp, model)


def _example_batch(cfg, B, L, U, rng):
    soft_map = np.full((B, L), -1, np.int32)
    soft_map[:, 2] = np.arange(B) % U
    labels = rng.integers(0, cfg.llama.vocab_size, (B, L)).astype(np.int32)
    labels[:, : L // 2] = -100
    return {
        "input_ids": rng.integers(4, cfg.llama.vocab_size,
                                  (B, L)).astype(np.int32),
        "seg_ids": np.ones((B, L), np.int32),
        "positions": np.broadcast_to(np.arange(L, dtype=np.int32),
                                     (B, L)).copy(),
        "soft_map": soft_map,
        "protein_embeds": rng.standard_normal(
            (U, cfg.encoder_out_dim)).astype(np.float32),
        "labels": labels,
        "ret_pos": np.full((B,), L - 1, np.int32),
        "ret_target_pos": (np.arange(B) % U).astype(np.int32),
        "ret_valid": np.ones((B,), bool),
    }


def _run_both(make_state, run, mesh):
    """run(state, mesh) with a one-process state and with the mesh's."""
    ref = run(make_state(None), None)
    got = run(make_state(mesh), mesh)
    return ref, got


def _close(name, got, ref, atol):
    for k in ("loss", "grad_norm"):
        err = abs(float(got[k]) - float(ref[k]))
        if not err <= atol * max(1.0, abs(float(ref[k]))):
            raise AssertionError(f"{name}: {k} {float(got[k])} on the mesh, "
                                 f"{float(ref[k])} in one process")
    return abs(float(got["loss"]) - float(ref["loss"]))


def phase_multitask(mesh, dev, dtype, attn):
    from procyon_tpu_torch.models import esm2, llama, lora, unified
    from procyon_tpu_torch.parallel import shard_batch
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    from procyon_tpu_torch.training.combined_step import make_combined_step

    cfg = unified.UnifiedConfig(
        llama=llama.LlamaConfig(vocab_size=256, dim=64, n_layers=2,
                                n_heads=4, n_kv_heads=2, intermediate=128,
                                max_seq_len=64, dtype=dtype, remat=False,
                                lora=lora.LoRAConfig(rank=4, num_experts=3,
                                                     dtype=dtype),
                                attn_backend=attn),
        esm=esm2.ESM2Config(dim=64, n_layers=2, n_heads=4, dtype=dtype,
                            max_seq_len=64, attn_backend=attn, remat=False),
        token_projector_layers=2, token_projector_hidden=64,
        retrieval_dim=32, dtype=dtype)
    params = unified.init_params(0, cfg, device=dev)
    opt = topt.build_optimizer(topt.OptimizerConfig(
        lr=1e-4, warmup_steps=10, total_steps=100))
    B = max(2 * mesh.size("batch"), 4)
    rng = np.random.default_rng(0)
    batch = _example_batch(cfg, B, 32, 4, rng)
    tokens = np.full((B, 16), esm2.PAD_IDX, np.int32)
    tokens[:, 0] = esm2.CLS_IDX
    tokens[:, 1:11] = rng.integers(4, 24, (B, 10))
    tokens[:, 11] = esm2.EOS_IDX
    labels = np.full((B, 16), -100, np.int32)
    labels[:, 3] = tokens[:, 3]
    masked = tokens.copy()
    masked[:, 3] = esm2.MASK_IDX
    batches = {"qa": batch,
               "caption": _example_batch(cfg, B, 32, 4,
                                         np.random.default_rng(1)),
               "retrieval": batch,
               "mlm": {"protein_tokens": masked, "mlm_labels": labels}}

    def make_state(m):
        return ts.init_train_state(copy.deepcopy(params), opt, mesh=m,
                                   cfg=cfg)

    def run(state, m):
        step = make_combined_step(cfg, opt)
        local = {t: shard_batch(ts.batch_to_device(b, dev), m)
                 if m is not None else ts.batch_to_device(b, dev)
                 for t, b in batches.items()}
        _, metrics = step(state, local)
        return metrics

    ref, got = _run_both(make_state, run, mesh)
    err = _close("multi-task step", got, ref, ATOL[dev])
    return {"loss": float(got["loss"]), "loss_err": err,
            "grad_norm": float(got["grad_norm"])}


def phase_flagship(mesh, dev, dtype, attn, dim):
    from procyon_tpu_torch.data.collators import encode_conflict_ids
    from procyon_tpu_torch.models import llama, lora, unified
    from procyon_tpu_torch.parallel import shard_batch
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    from procyon_tpu_torch.training.combined_step import make_combined_step

    cfg = unified.UnifiedConfig(
        llama=llama.LlamaConfig(
            vocab_size=4096, dim=dim, n_layers=2, n_heads=dim // 128,
            n_kv_heads=dim // 512, intermediate=int(dim * 3.5),
            rope_theta=500000.0, max_seq_len=64, dtype=dtype,
            attn_backend=attn, remat=False,
            lora=lora.LoRAConfig(rank=16, num_experts=4, dtype=dtype)),
        esm=None, protein_embed_dim=2560, token_projector_layers=3,
        token_projector_hidden=2560, retrieval_dim=1024,
        use_protein_struct=True, struct_embed_dim=512,
        use_drug_embeddings=True, drug_embed_dim=512, dtype=dtype)
    params = unified.init_params(0, cfg, device=dev)
    opt = topt.build_optimizer(topt.OptimizerConfig(
        lr=1e-4, warmup_steps=10, total_steps=100))
    B, U, US, UD, L = max(mesh.size("batch"), 4), 4, 2, 2, 48

    def fusion_batch(seed, with_labels=True):
        r = np.random.default_rng(seed)
        b = _example_batch(cfg, B, L, U, r)
        b["soft_map"][:, 4] = U + (np.arange(B) % US)
        b["soft_map"][:, 6] = U + US + (np.arange(B) % UD)
        b["struct_embeds"] = r.standard_normal(
            (US, cfg.struct_embed_dim)).astype(np.float32)
        b["drug_embeds"] = r.standard_normal(
            (UD, cfg.drug_embed_dim)).astype(np.float32)
        b["conflict_ids"] = encode_conflict_ids(3, (np.arange(B) % U)
                                                .tolist())
        if not with_labels:
            b.pop("labels")
        return b

    micro = [fusion_batch(s) for s in (1, 2)]
    joint = {"qa": fusion_batch(3), "retrieval": fusion_batch(4)}

    def make_state(m):
        return ts.init_train_state(copy.deepcopy(params), opt, mesh=m,
                                   cfg=cfg)

    def run(state, m):
        qa = ts.make_train_step(cfg, opt, "qa", accumulation_steps=2)
        acc = ts.stack_microbatches([
            shard_batch(b, m) if m is not None else b for b in micro])
        acc = ts.batch_to_device(acc, dev)
        state, m1 = qa(state, acc)
        step = make_combined_step(cfg, opt, expert_override=3)
        local = {t: ts.batch_to_device(b, dev) for t, b in joint.items()}
        if m is not None:
            local = {t: shard_batch(b, m) for t, b in local.items()}
        _, m4 = step(state, local)
        return {"qa": m1, "joint": m4}

    ref, got = _run_both(make_state, run, mesh)
    errs = {k: _close(f"flagship {k} step", got[k], ref[k], ATOL[dev])
            for k in ("qa", "joint")}
    return {"dim": dim, "qa_loss": float(got["qa"]["loss"]),
            "joint_loss": float(got["joint"]["loss"]),
            "loss_err": max(errs.values())}


SERVING_MODES = [
    ("plain", {}, False),
    ("kv8", {}, True),
    ("spec_k2", {"spec_k": 2}, False),
    ("prefix+wave", {"prefix_cache": True, "prefill_chunk": 4,
                     "prefill_batch": 2}, False),
]


def _hook(b, log, errs=None):
    """Records every token choice of batcher `b` (`_sample` and the greedy
    speculative `_greedy_accept`) with its logits, or, given `errs`,
    replays the recorded choices and appends each one's largest logit
    error."""
    sample, accept = b._sample, b._greedy_accept

    def seen(logits, choice):
        if errs is None:
            log.append((logits.float().clone(), choice))
            return choice
        want_logits, want = log[len(errs)]
        errs.append((logits.float() - want_logits).abs().max().item())
        return want

    b._sample = lambda logits: seen(logits, sample(logits))
    b._greedy_accept = lambda tokens, logits: seen(
        logits, accept(tokens, logits))


def phase_serving(mesh, dev, dtype, attn):
    """TP tokens against the one-process batcher in the four modes; on
    the card the mesh batcher is stepped under the one-process tokens."""
    from procyon_tpu_torch.inference import kv_pool
    from procyon_tpu_torch.inference.serving import ContinuousBatcher
    from procyon_tpu_torch.models import llama
    import torch.distributed as dist

    cfg = llama.tiny_config(attn_backend=attn, remat=False, dim=256,
                            n_heads=4, n_kv_heads=2, intermediate=512,
                            vocab_size=512, dtype=dtype)
    params = llama.init_params(7, cfg, device=dev)

    def pcfg(quantize_kv):
        return kv_pool.PagedConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, page_size=4, n_pages=32,
            max_pages_per_seq=8, slots=2, dtype=cfg.dtype,
            quantize_kv=quantize_kv)

    rng = np.random.default_rng(7)
    shared = list(map(int, rng.integers(4, cfg.vocab_size, 9)))
    prompts = [shared + list(map(int, rng.integers(4, cfg.vocab_size, n)))
               for n in (3, 5, 4)]
    fused = rng.standard_normal((7, cfg.dim)).astype(np.float32) * 0.1

    def workload(b):
        rids = [b.submit(p, max_new=4) for p in prompts]
        rids.append(b.submit_fused(fused, max_new=4))
        out = b.run()
        return [out[r] for r in rids]

    out = {}
    for name, kw, qkv in SERVING_MODES:
        ref_b = ContinuousBatcher(params, cfg, pcfg(qkv), device=dev, **kw)
        log, errs = [], []
        _hook(ref_b, log)
        ref = workload(ref_b)
        b = ContinuousBatcher(params, cfg, pcfg(qkv), mesh=mesh, device=dev,
                              **kw)
        if dev != "cpu":
            _hook(b, log, errs)
        got = workload(b)
        if got != ref:
            raise AssertionError(f"serving {name}: {got} on the mesh, {ref} "
                                 "in one process")
        if errs and max(errs) > SERVING_LOGIT_ATOL:
            raise AssertionError(f"serving {name}: logits {max(errs)} from "
                                 "the one-process run")
        if name == "prefix+wave" and b.pcache.stats["hit_tokens"] <= 0:
            raise AssertionError("serving prefix+wave: no prefix-cache hit")
        free = ContinuousBatcher(params, cfg, pcfg(qkv), mesh=mesh,
                                 device=dev, **kw)
        mine = workload(free)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        if any(t != mine for t in every):
            raise AssertionError(f"serving {name}: the ranks' own tokens "
                                 "differ")
        out[name] = {"max_logit_err": max(errs) if errs else 0.0,
                     "pool_lanes": int(b.pool["k"].shape[-1])}
    return out


def run_phases(dev, rank, world):
    from procyon_tpu_torch import parallel
    dtype = torch.float32 if dev == "cpu" else torch.bfloat16
    attn = "ref" if dev == "cpu" else None
    mesh = parallel.create_mesh(parallel.MeshConfig(*default_mesh(world)))
    result = {"rank": rank, "mesh": mesh.shape,
              "multitask": phase_multitask(mesh, dev, dtype, attn),
              "flagship": phase_flagship(mesh, dev, dtype, attn,
                                         FLAGSHIP_DIM[dev]),
              "serving": phase_serving(mesh, dev, dtype, attn)}
    return "dryrun_multichip OK " + json.dumps(result)


def _rank_main(rank, world, port, dev, out_dir):
    from procyon_tpu_torch import parallel
    if dev == "cpu":
        torch.set_num_threads(1)
    parallel.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                  backend="gloo", device=dev)
    line = run_phases(dev, rank, world)
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(line)
    torch.distributed.destroy_process_group()


def main(argv=None):
    import torch.distributed as dist
    import torch.multiprocessing as mp
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if dist.is_available() and dist.is_initialized() or \
            "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        from procyon_tpu_torch import parallel
        rank, world = parallel.initialize_multihost(device=args.device)
        print(run_phases(args.device, rank, world), flush=True)
        dist.destroy_process_group()
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, args=(args.ranks, port,
                                                   args.device, out_dir),
                                 nprocs=args.ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{TIMEOUT_S} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException,
                TimeoutError) as e:
            print(f"dryrun_multichip FAILED: {e}", flush=True)
            return 1
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        for r in range(args.ranks):
            with open(os.path.join(out_dir, f"rank{r}.txt")) as f:
                print(f.read(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
