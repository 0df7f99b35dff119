"""Caption (diverse beam) decode throughput: caption tokens/sec on one card
(counterpart of scripts/bench_caption.py).

ProCyon-Full's caption bulk decode (scripts/caption_bulk.py's path) on a
Llama-class decoder with the reference's pinned generation settings: beam
10, groups of 2, diversity penalty 0.8 (caption_bulk.py:121-132). The beam
steps are stepped from the host (generation.beam_step, or
paged_beam.paged_beam_step under --paged); two-point timing over
`gen_small` and `gen_big` steps (the best of two runs each) cancels the
prefill and the final wait.

The decoder: dim 4096 x 34 layers (head_dim 128, a KV head per four query
heads, intermediate dim x 2.6875, vocabulary 32000), or `--llama3`'s
Llama-3-8B (128256 vocabulary, GQA 32 / 8, intermediate 14336). Weights are
constants quantized to `--bits` (int8 codes 1, floats 0.01; the time does
not depend on their values), or seeded bf16 under --no-quant; quantized
lines carry the quality probe (evaluate/quant_quality.probe) and exit 1
when its gate fails.

    python -m procyon_tpu_torch.scripts.bench_caption [--llama3 --bits 4
        --paged] [--cascade on|off|ab] [--shared_prefix 64] [--kv8]

`--paged` decodes on the paged beam pool (shared prompt pages, page-table
reorder, copy-on-write of each beam's partial page by the direct page move,
csrc/page_move.cu). `--cascade on` (the default) gathers a beam group's
prompt pages once (llama._cascade_decode_attention); `off` sends every
decode layer through the paged attention kernel (csrc/paged_attention.cu)
when the pool holds at least 512 tokens a slot; `ab` times both in one
session. `--shared_prefix S` gives every prompt the same first S tokens and
reports the prefill with and without the within-batch dedup and a
cross-batch BeamPoolSession's steady state. Prefills of more than 16
tokens take the flash forward (csrc/flash_attention_fwd.cu); `--bits 4`
products of at most 256 rows the int4 matmul (csrc/int4_matmul.cu).
`--step_trip K > 1` (K-step scan trips) is not ported: eager PyTorch steps
every beam step from the host.

It prints one JSON line, `caption_decode_tokens_per_sec_chip`, with the
estimated A100 denominators and the card's name, power limit and canary.
`--device cpu` decodes in f32 and times nothing. `main(argv)` returns the
result as a dict; `bench_config`, `build_params`, `prompt_batch`,
`gen_config`, `captioner` and `run` are the pieces a caller with its own
weights uses.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.evaluate import quant_quality
from procyon_tpu_torch.inference import generation, paged_beam
from procyon_tpu_torch.models import llama, unified
from procyon_tpu_torch.scripts.bench_decode import constant_quantized_params
from procyon_tpu_torch.utils import baselines, timing


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt_len", type=int, default=128)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--beam_group_size", type=int, default=2)
    p.add_argument("--gen_small", type=int, default=16)
    p.add_argument("--gen_big", type=int, default=48)
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--layers", type=int, default=34)
    p.add_argument("--quant", action="store_true", default=True)
    p.add_argument("--no-quant", dest="quant", action="store_false")
    p.add_argument("--bits", type=int, default=8, choices=(4, 8),
                   help="weight quantization width (4 = packed int4)")
    p.add_argument("--llama3", action="store_true",
                   help="the Llama-3-8B config (128k vocabulary, GQA 32/8, "
                        "14336 intermediate)")
    p.add_argument("--paged", action="store_true",
                   help="decode on the paged beam pool instead of the dense "
                        "per-beam cache")
    p.add_argument("--page_size", type=int, default=64)
    p.add_argument("--kv8", action="store_true",
                   help="int8 KV pool (paged only)")
    p.add_argument("--shared_prefix", type=int, default=0,
                   help="an identical leading S tokens in every prompt; "
                        "times the init with and without the shared-prefix "
                        "dedup and a cross-batch session (paged only)")
    p.add_argument("--quality", action="store_true", default=True,
                   help="run the quantization quality probe and gate the "
                        "result")
    p.add_argument("--no-quality", dest="quality", action="store_false")
    p.add_argument("--cascade", choices=("on", "off", "ab"), default="on",
                   help="grouped-prefix cascade decode attention (paged "
                        "only); 'ab' times both in one session")
    p.add_argument("--step_trip", type=int, default=0,
                   help="K-step scan trips: not ported (raises for K > 1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.kv8 and not args.paged:
        p.error("--kv8 requires --paged (the dense cache has no "
                "quantized variant)")
    if args.step_trip > 1:
        raise NotImplementedError(
            "--step_trip: K-step scan trips (paged_beam_step_trip) are not "
            "ported; eager PyTorch steps every beam step from the host "
            "(ROADMAP queue 1, item 6, 'Not to port')")
    return args


def bench_config(args):
    on_cpu = torch.device(args.device).type == "cpu"
    dtype = torch.float32 if on_cpu else torch.bfloat16
    kw = dict(max_seq_len=args.prompt_len + args.gen_big + 32, dtype=dtype,
              attn_backend="ref" if on_cpu else None, remat=False)
    if args.llama3:
        lcfg = llama.llama3_8b(**kw)
    else:
        lcfg = llama.LlamaConfig(
            vocab_size=32000, dim=args.dim, n_layers=args.layers,
            n_heads=args.dim // 128, n_kv_heads=max(args.dim // 512, 1),
            intermediate=int(args.dim * 2.6875), **kw)
    return unified.UnifiedConfig(
        llama=lcfg, esm=None, protein_embed_dim=64, token_projector_layers=1,
        token_projector_hidden=64, retrieval_dim=64, dtype=dtype)


def build_params(cfg, args):
    """(params, n_params, weight tag): constant quantized weights, or
    seeded ones under --no-quant. n_params counts the unquantized
    decoder's."""
    n_params = sum(t.numel() for t in bridge.tree_leaves(
        unified.init_params(0, cfg, device="meta")["llama"]))
    if args.quant:
        return (constant_quantized_params(cfg, args.bits, args.device),
                n_params, f"int{args.bits}")
    return (unified.init_params(args.seed, cfg, device=args.device),
            n_params, "bf16" if cfg.dtype == torch.bfloat16 else "f32")


def prompt_batch(cfg, B, L, shared_prefix=0, *, seed=0):
    """B random prompts of L tokens (the reference's draws), the first
    `shared_prefix` tokens row 0's in every row; numpy arrays."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.llama.vocab_size, (B, L))
    if shared_prefix:
        ids[:, :shared_prefix] = ids[0, :shared_prefix]
    return {
        "input_ids": ids.astype(np.int32),
        "seg_ids": np.ones((B, L), np.int32),
        "positions": np.broadcast_to(np.arange(L, dtype=np.int32),
                                     (B, L)).copy(),
        "soft_map": np.full((B, L), -1, np.int32),
        "protein_embeds": np.zeros((1, cfg.protein_embed_dim), np.float32),
    }


def gen_config(args):
    return generation.GenerationConfig(
        max_new_tokens=args.gen_big + 8, method="beam",
        beam_size=args.beam_size, beam_group_size=args.beam_group_size,
        diversity_penalty=0.8, eos_token_id=2, pad_token_id=0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def captioner(params, cfg, batch, gen, *, paged=False, page_size=64,
              kv8=False, cascade=True):
    """run(n) -> ((tokens [B, beam, T], scores [B, beam]) ranked, seconds
    of the steps): a fresh prefill (and pool), then the beam steps, stepped
    from the host and synchronized before and after. Paged: a burn-in step
    0, then steps 1..n timed; dense: steps 0..n-1 timed. `ctx` (paged):
    the init's page plan, sized once."""
    dev = params["llama"]["embed"].device
    if paged:
        state0, ctx = paged_beam.paged_beam_init(
            params, cfg, batch, gen, page_size=page_size, quantize_kv=kv8)
        del state0
        cpages = ctx["cascade_pages"] if cascade else None

        @torch.no_grad()
        def run(n):
            state, _ = paged_beam.paged_beam_init(
                params, cfg, batch, gen, page_size=page_size,
                quantize_kv=kv8)

            def step(state, t):
                return paged_beam.paged_beam_step(
                    params, cfg, gen, ctx["pcfg"], ctx["beam"],
                    ctx["private"], ctx["g0"], state, t,
                    cascade_pages=cpages, max_position=ctx["max_len"] + t)

            state = step(state, 0)
            _sync(dev)
            t0 = time.perf_counter()
            for t in range(1, n + 1):
                state = step(state, t)
            _sync(dev)
            return (generation.rank_beams(state[0], state[3]),
                    time.perf_counter() - t0)
        run.ctx = ctx
        return run

    dense = paged_beam.to_device(batch, dev)

    @torch.no_grad()
    def run(n):
        state = generation.beam_init(params, cfg, dense, gen)
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(n):
            state = generation.beam_step(params, cfg, gen, state, t)
        _sync(dev)
        return (generation.rank_beams(state[0], state[4]),
                time.perf_counter() - t0)
    run.ctx = None
    return run


def two_point(go, args):
    """Seconds a step: the best of two runs at gen_small and at gen_big
    steps, after a 2-step warm-up."""
    go(2)
    t_small = min(go(args.gen_small)[1] for _ in range(2))
    t_big = min(go(args.gen_big)[1] for _ in range(2))
    return (t_big - t_small) / (args.gen_big - args.gen_small)


def shared_prefix_ab(params, cfg, batch, gen, args):
    """The paged init with and without the shared-prefix dedup (seconds,
    pool pages), then a BeamPoolSession over five batches of new tails
    behind the same prefix: the first batch's init and the steady state's,
    with the cache's hit pages a batch."""
    dev = params["llama"]["embed"].device

    def timed_init(sp):
        t0 = time.perf_counter()
        _, cx = paged_beam.paged_beam_init(
            params, cfg, batch, gen, page_size=args.page_size,
            quantize_kv=args.kv8, shared_prefix=sp)
        _sync(dev)
        return time.perf_counter() - t0, cx["pcfg"].n_pages

    for sp in (False, True):              # the first launches
        timed_init(sp)
    t_priv, pg_priv = timed_init(False)
    t_sh, pg_sh = timed_init(True)
    B, L = batch["input_ids"].shape
    sess = paged_beam.BeamPoolSession(page_size=args.page_size,
                                      quantize_kv=args.kv8)

    def timed_session_init(k):
        ids = batch["input_ids"].copy()
        ids[:, args.shared_prefix:] = np.random.default_rng(
            1000 + k).integers(4, cfg.llama.vocab_size,
                               (B, L - args.shared_prefix))
        t0 = time.perf_counter()
        st, cx = paged_beam.paged_beam_init(
            params, cfg, {**batch, "input_ids": ids}, gen, session=sess)
        _sync(dev)
        dt = time.perf_counter() - t0
        sess.end_batch(cx["session_rec"], st[1])
        return dt, len(cx["session_rec"]["hits"])

    t_first, _ = timed_session_init(0)
    steady, hits = [], []
    for k in range(1, 5):
        dt, hp = timed_session_init(k)
        steady.append(round(dt, 3))
        hits.append(hp)
    return {"init_private_s": round(t_priv, 3),
            "init_shared_s": round(t_sh, 3),
            "init_session_first_s": round(t_first, 3),
            "init_session_steady_s": steady,
            "session_hit_pages_per_batch": hits,
            "session_prefill_tokens_skipped": hits[-1] * args.page_size,
            "pool_pages_private": pg_priv, "pool_pages_shared": pg_sh}


def run(params, cfg, args, *, n_params, wtag):
    """The two-point beam-step time on the card (captions only on the CPU)
    and the JSON line. Returns {"line", "captions", "gate_failed"}."""
    on_card = torch.device(args.device).type == "cuda"
    batch = prompt_batch(cfg, args.batch, args.prompt_len,
                         args.shared_prefix, seed=args.seed)
    gen = gen_config(args)
    shared_ab = {}
    if args.paged and args.shared_prefix and on_card:
        shared_ab = shared_prefix_ab(params, cfg, batch, gen, args)
    go = captioner(params, cfg, batch, gen, paged=args.paged,
                   page_size=args.page_size, kv8=args.kv8,
                   cascade=args.cascade != "off")
    captions, _ = go(args.gen_small)
    per_step = two_point(go, args) if on_card else None
    cascade_ab = {}
    ctx = go.ctx
    if on_card and args.paged and args.cascade == "ab" \
            and ctx["cascade_pages"]:
        flat = captioner(params, cfg, batch, gen, paged=True,
                         page_size=args.page_size, kv8=args.kv8,
                         cascade=False)
        per_step_flat = two_point(flat, args)
        cascade_ab = {"per_step_ms_flat": round(per_step_flat * 1e3, 2),
                      "cascade_speedup": round(per_step_flat / per_step, 3)}

    def t(x, digits):
        return round(x, digits) if on_card else None

    result = {
        "metric": "caption_decode_tokens_per_sec_chip",
        "value": t(args.batch / per_step, 2) if on_card else None,
        "unit": f"caption tok/s (B{args.batch} x beam{args.beam_size}, "
                f"~{n_params / 1e9:.1f}B params, {wtag}, diverse beam"
                f"{', paged' if args.paged else ''})",
        "beam_tokens_per_sec": t(args.batch * args.beam_size / per_step, 1)
        if on_card else None,
        "per_step_ms": t(per_step * 1e3, 2) if on_card else None,
        "backend": "paged" if args.paged else "dense",
        "kv_int8": bool(args.kv8 and args.paged),
        **({"cascade": args.cascade != "off"
            and bool(ctx["cascade_pages"]), **cascade_ab}
           if args.paged else {}),
    }
    if args.paged and args.shared_prefix:
        result["shared_prefix_tokens"] = args.shared_prefix
        result.update(shared_ab)
    if on_card:
        result.update(baselines.baseline_fields(
            float(n_params), args.batch, args.batch / per_step))
    gate_failed = False
    if args.quality and args.quant:
        q = quant_quality.probe(args.bits, "dequant", device=args.device)
        result.update(q.as_dict())
        gate_failed = not q.passed
    result.update(timing.canary_fields() if on_card else {"timed": False})
    return {"line": result, "captions": captions, "gate_failed": gate_failed}


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed run")
    cfg = bench_config(args)
    params, n_params, wtag = build_params(cfg, args)
    res = run(params, cfg, args, n_params=n_params, wtag=wtag)
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    sys.exit(1 if main()["gate_failed"] else 0)
