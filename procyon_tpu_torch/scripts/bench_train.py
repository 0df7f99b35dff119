"""Training-step throughput: supervised tokens/sec on one card and MFU
(counterpart of scripts/bench_train.py).

Default: the fusion model's QA language-model step (AdamW, the frozen
protein-table mode of ProCyon-Full) at a small shape, every weight trained.

--flagship: the one-card QLoRA recipe at Llama-3-8B shape: the decoder
quantized to int8 (or --bits 4) and frozen, bf16 task-banked LoRA experts
(r16 x 4 on wq / wv), the projectors and the contrastive temperature
trained, S 2048, remat. --combined: the joint QA + retrieval step
(training/combined_step.make_combined_step on expert 3, two forward and
backward passes a step) in place of the QA step.

MFU is the model's matmul FLOPs a step (`train_flops_per_token`) over the
step's time and the H100's dense bf16 peak, 989 TFLOP/s. The time is
two-pointed over `steps_small` and `steps_big` steps, the best of two runs
at each point, after two warm-up steps, each run ended by reading the loss
(a synchronize). On the card the attention's forward is the flash kernel
(csrc/flash_attention_fwd.cu) and its backward the dq and dk / dv kernels
(csrc/flash_attention_bwd.cu); the line carries their launches a step.

    python -m procyon_tpu_torch.scripts.bench_train [--dim 1024 --layers 8
        --batch 8 --seq 512]
    python -m procyon_tpu_torch.scripts.bench_train --flagship [--bits 8
        --batch 2] [--combined]

It prints one JSON line, `train_tokens_per_sec_chip`, with the card's
name, power limit and canary. `--device cpu` runs the steps in f32 and
times nothing. `main(argv)` returns the result as a dict;
`matmul_params`, `train_flops_per_token`, `train_batch`, `qlora_config`,
`qlora_params`, `make_step` and `run` are the pieces a caller with its own
weights uses.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import llama, lora, unified
from procyon_tpu_torch.ops import launch_counts, launches_since
from procyon_tpu_torch.training import combined_step as tcs
from procyon_tpu_torch.training import optimizer as topt
from procyon_tpu_torch.training import train_step as ts
from procyon_tpu_torch.utils import timing

H100_BF16_PEAK = 989e12    # dense, SXM, at the 700 W limit
SOFT_TOKENS = 8            # protein embeddings a batch (the reference's U)
PROTEIN_EMBED_DIM = 2560   # ESM2-3B's table width
LAUNCHES = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")


def matmul_params(cfg):
    """Weight elements participating in matmuls (layers + lm_head)."""
    d, hd = cfg.dim, cfg.head_dim
    per_layer = (d * cfg.n_heads * hd            # wq
                 + 2 * d * cfg.n_kv_heads * hd   # wk, wv
                 + cfg.n_heads * hd * d          # wo
                 + 3 * d * cfg.intermediate)     # gate, up, down
    return cfg.n_layers * per_layer + d * cfg.vocab_size  # + lm_head


def train_flops_per_token(cfg, seq, *, frozen_base: bool, remat: bool):
    """Matmul-FLOPs accounting: fwd 2P; bwd dL/dx 2P always; dL/dW 2P only
    for trainable weights; remat recomputes the fwd (+2P). Attention adds
    2*2*S*d per token per layer, causal-halved, x(fwd + bwd + remat)."""
    P = matmul_params(cfg)
    factor = 2 + 2 + (0 if frozen_base else 2) + (2 if remat else 0)
    attn = 2 * seq * cfg.dim * cfg.n_layers  # 4*S*d halved for causality
    attn_factor = (1 + 1 + (1 if remat else 0))
    return factor * P + attn_factor * attn


def train_batch(B, S, vocab, embed_dim=PROTEIN_EMBED_DIM, seed=0,
                soft_tokens=SOFT_TOKENS):
    """The reference's batch as numpy arrays, the same draws: random
    tokens, labels over the second half, one soft token at position 2
    (`soft_tokens` protein embeddings), the retrieval position at the last
    token."""
    rng = np.random.default_rng(seed)
    U = soft_tokens
    soft_map = np.full((B, S), -1, np.int32)
    soft_map[:, 2] = np.arange(B) % U
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, :S // 2] = -100
    return {"input_ids": rng.integers(4, vocab, (B, S)).astype(np.int32),
            "seg_ids": np.ones((B, S), np.int32),
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy(),
            "soft_map": soft_map,
            "protein_embeds": rng.standard_normal(
                (U, embed_dim)).astype(np.float32),
            "labels": labels,
            "ret_pos": np.full((B,), S - 1, np.int32),
            "ret_target_pos": (np.arange(B) % U).astype(np.int32),
            "ret_valid": np.ones((B,), bool)}


def qlora_config(cfg, rank=16, experts=4):
    """cfg with LoRA banks (rank x experts, on wq / wv) in the decoder's
    dtype and remat on: the one-card recipe."""
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, remat=True, lora=lora.LoRAConfig(
            rank=rank, num_experts=experts, dtype=cfg.llama.dtype)))


def qlora_params(params, cfg, g, b_scale=0.0, bits=8):
    """params with LoRA banks added to the decoder (A ~ N(0, 1/dim); B 0,
    or N(0, b_scale^2) where the gradient of A must not vanish) and the
    decoder's matrices quantized to `bits`. g: a generator on the
    parameters' device."""
    lcfg = cfg.llama
    layers = dict(params["llama"]["layers"])
    for name, out in (("lora_wq", lcfg.n_heads * lcfg.head_dim),
                      ("lora_wv", lcfg.n_kv_heads * lcfg.head_dim)):
        banks = [lora.init_params(g, lcfg.lora, lcfg.dim, out,
                                  device=g.device)
                 for _ in range(lcfg.n_layers)]
        layers[name] = {k: torch.stack([b[k] for b in banks])
                        for k in ("A", "B")}
        if b_scale:
            layers[name]["B"] = (b_scale * torch.randn(
                layers[name]["B"].shape, generator=g, device=g.device)).to(
                lcfg.dtype)
    decoder = llama.quantize_params(dict(params["llama"], layers=layers),
                                    lcfg, bits=bits)
    return dict(params, llama=decoder)


def bench_config(args):
    """The decoder (Llama-3-8B's under --flagship, else the reference's
    small rule: head_dim 128, a KV head per two query heads, intermediate
    dim x 2.6875, vocabulary 32000) and the fusion model's projectors; bf16
    on the card, f32 on the plain attention on the CPU."""
    on_cpu = torch.device(args.device).type == "cpu"
    dtype = torch.float32 if on_cpu else torch.bfloat16
    backend = "ref" if on_cpu else None
    if args.flagship:
        lcfg = llama.llama3_8b(max_seq_len=args.seq, dtype=dtype,
                               attn_backend=backend,
                               n_layers=args.layers or 32)
    else:
        lcfg = llama.LlamaConfig(
            vocab_size=32000, dim=args.dim, n_layers=args.layers,
            n_heads=args.dim // 128, n_kv_heads=max(args.dim // 256, 1),
            intermediate=int(args.dim * 2.6875), max_seq_len=args.seq,
            dtype=dtype, attn_backend=backend)
    cfg = unified.UnifiedConfig(
        llama=lcfg, esm=None, protein_embed_dim=PROTEIN_EMBED_DIM,
        token_projector_layers=3, token_projector_hidden=2560,
        retrieval_dim=1024, dtype=dtype)
    if args.flagship:
        cfg = qlora_config(cfg, args.lora_rank, args.lora_experts)
    return cfg


def make_step(cfg, params, *, frozen_base, combined, lr=1e-4,
              warmup_steps=10):
    """(state, step(state, batch), task tag, passes a step) for the QA
    step, or the combined QA + retrieval step on expert 3; frozen_base: the
    QLoRA state (train_step.lora_trainable_predicate's leaves trained)."""
    opt = topt.build_optimizer(topt.OptimizerConfig(
        lr=lr, warmup_steps=warmup_steps, total_steps=1000))
    state = ts.init_train_state(
        params, opt, trainable_predicate=ts.lora_trainable_predicate
        if frozen_base else None)
    if combined:
        joint = tcs.make_combined_step(cfg, opt, expert_override=3,
                                       frozen_base=frozen_base)

        def step(s, b):
            return joint(s, {"qa": b, "retrieval": b})
        return state, step, "joint qa+retrieval step", 2
    return (state, ts.make_train_step(cfg, opt, "qa",
                                      frozen_base=frozen_base),
            "qa step", 1)


def run(step, state, batch, cfg, *, seq, batch_size, passes, frozen_base,
        steps_small=4, steps_big=12, warm=2, repeats=2, n_params,
        n_trainable, task_tag, wtag, device="cuda"):
    """warm steps of `step`, then `repeats` runs of steps_small and of
    steps_big steps (on the host clock; the best run at each point,
    two-pointed) and the JSON line. Returns {"line", "state", "losses":
    each run's last loss, "launches_per_step": rows 3, 8, 9}."""
    on_card = torch.device(device).type == "cuda"
    before = launch_counts()
    losses = []

    def go(n):
        nonlocal state
        t0 = time.perf_counter()
        m = None
        for _ in range(n):
            state, m = step(state, batch)
        losses.append(float(m["loss"]))
        return time.perf_counter() - t0

    go(warm)
    repeats = repeats if on_card else 1      # nothing is timed elsewhere
    t_small = min(go(steps_small) for _ in range(repeats))
    t_big = min(go(steps_big) for _ in range(repeats))
    n = warm + repeats * (steps_small + steps_big)
    counts = launches_since(before)
    per = [counts[k] / n for k in LAUNCHES]
    per_step = (t_big - t_small) / (steps_big - steps_small)
    tokens_per_step = batch_size * seq * passes
    flops_per_step = tokens_per_step * train_flops_per_token(
        cfg.llama, seq, frozen_base=frozen_base, remat=cfg.llama.remat)
    supervised = int((batch["labels"][:, 1:] != -100).sum()) * passes
    line = {
        "metric": "train_tokens_per_sec_chip",
        "value": round(tokens_per_step / per_step, 1) if on_card else None,
        "unit": f"tok/s ({task_tag}, B{batch_size} S{seq}, "
                f"~{n_params / 1e9:.1f}B params, {wtag}, AdamW)",
        "per_step_ms": round(per_step * 1e3, 2) if on_card else None,
        "supervised_tok_per_sec": round(supervised / per_step, 1)
        if on_card else None,
        "mfu": round(flops_per_step / per_step / H100_BF16_PEAK, 4)
        if on_card else None,
        "model_flops_per_step": float(flops_per_step),
        "n_trainable_params": int(n_trainable),
        "first_loss": losses[0], "last_loss": losses[-1],
        "launches_per_step": dict(zip(LAUNCHES, per)),
        **(timing.canary_fields() if on_card else {"timed": False})}
    return {"line": line, "state": state, "losses": losses,
            "launches_per_step": per, "per_step_s": per_step}


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--layers", type=int, default=None,
                   help="decoder layers (default 8; 32 under --flagship)")
    p.add_argument("--batch", type=int, default=None,
                   help="default 8; 2 under --flagship")
    p.add_argument("--seq", type=int, default=None,
                   help="default 512; 2048 under --flagship")
    p.add_argument("--steps_small", type=int, default=4)
    p.add_argument("--steps_big", type=int, default=12)
    p.add_argument("--flagship", action="store_true",
                   help="Llama-3-8B shape, int8 / int4 frozen base + bf16 "
                        "LoRA experts, S 2048, remat")
    p.add_argument("--bits", type=int, default=8, choices=(4, 8))
    p.add_argument("--lora_rank", type=int, default=16)
    p.add_argument("--lora_experts", type=int, default=4)
    p.add_argument("--combined", action="store_true",
                   help="the joint qa + retrieval combined step instead of "
                        "the qa step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None):
    args = parser().parse_args(argv)
    if args.batch is None:
        args.batch = 2 if args.flagship else 8
    if args.seq is None:
        args.seq = 2048 if args.flagship else 512
    if args.layers is None and not args.flagship:
        args.layers = 8
    return args


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed run")
    cfg = bench_config(args)
    params = unified.init_params(args.seed, cfg, device=args.device)
    n_params = sum(t.numel() for t in bridge.tree_leaves(
        llama.init_params(0, cfg.llama, device="meta")))
    wtag = "bf16" if cfg.dtype == torch.bfloat16 else "f32"
    if args.flagship:
        g = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        params = qlora_params(params, cfg, g, bits=args.bits)
        wtag = (f"int{args.bits} frozen base + {wtag} LoRA "
                f"r{args.lora_rank}x{args.lora_experts}")
    state, step, task_tag, passes = make_step(
        cfg, params, frozen_base=args.flagship, combined=args.combined)
    del params
    n_trainable = sum(x.numel() for _, x in topt.tree_items(state["params"]))
    batch = ts.batch_to_device(
        train_batch(args.batch, args.seq, cfg.llama.vocab_size,
                    seed=args.seed), args.device)
    res = run(step, state, batch, cfg, seq=args.seq, batch_size=args.batch,
              passes=passes, frozen_base=args.flagship,
              steps_small=args.steps_small, steps_big=args.steps_big,
              n_params=n_params, n_trainable=n_trainable, task_tag=task_tag,
              wtag=wtag, device=args.device)
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    main()
