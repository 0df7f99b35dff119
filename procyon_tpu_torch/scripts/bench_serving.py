"""Serving throughput of the continuous batcher (counterpart of
scripts/bench_serving.py).

Workload: N mixed requests (token prompts and fused soft-token prompts, the
two admission paths of inference/serving.py) with staggered arrivals into
one ContinuousBatcher. The drive loop submits by the arrival schedule
between serving ticks and measures wall-clock end to end, so the number
includes prefill, admission queueing, page recycling and each round's
host trip (token ids only: sampling is on the device).

Reported (one JSON line):
  requests_per_sec   completed requests / wall time
  output_tok_per_sec generated tokens / wall time
  latency p50 / p95  submit -> finish wall seconds a request
  slot_utilization   mean live slots / slots over ticks
  ms_per_round       ticks that ran a round, less their admissions
  pool sizing        n_pages under the fixed --pool_mb budget (--kv8 halves
                     a page's bytes: about twice the pages)
with the estimated A100 denominators (utils/baselines.baseline_fields,
serving=True) and the card's name, power limit and canary
(utils/timing.canary_fields).

The timed weights are an int8 tree of varied codes (int8 codes drawn in
[-8, 8], scales 0.01, unit norms, an N(0, 0.02^2) embedding): a
constant-weight model greedy-decodes one token forever, which makes every
n-gram draft accept and fakes a perfect speculative acceptance rate.
`--ngram_period P` takes models/synthetic.py's induced-bigram checkpoint
instead, whose greedy decode walks a period-P token chain.

    python -m procyon_tpu_torch.scripts.bench_serving [--dim 4096
        --layers 34 --slots 16 --requests 48 --max_new 64
        --step_quantum 8 --pool_mb 1024] [--kv8] [--prefix_cache
        --shared_prefix 256] [--spec_k 7 --spec_quantum 4]
    python -m procyon_tpu_torch.scripts.bench_serving --synthetic
        --device cpu            # the tiny model, untimed

On the card the prefills of more than 16 tokens take the flash forward
(csrc/flash_attention_fwd.cu), decode steps on a bf16 pool of at least 512
tokens a slot the paged attention (csrc/paged_attention.cu; an int8 pool
takes the gather route, the reference's rule), and an int4 tree's products
of at most 256 rows the int4 matmul (csrc/int4_matmul.cu). `--device cpu`
runs the same schedule in f32 on the plain versions and reports counts
only (`timed: false`). `main(argv)` returns the result as a dict;
`make_workload`, `pool_config`, `make_batcher`, `drive` and `run` are the
pieces a caller with its own weights uses.
"""

import argparse
import json
import time

import numpy as np
import torch

from procyon_tpu_torch.inference import kv_pool, serving
from procyon_tpu_torch.models import llama, synthetic
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.utils import baselines, timing

VOCAB = 32000


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--layers", type=int, default=34)
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--requests", type=int, default=48)
    p.add_argument("--min_prompt", type=int, default=64)
    p.add_argument("--max_prompt", type=int, default=256)
    p.add_argument("--max_new", type=int, default=64)
    p.add_argument("--step_quantum", type=int, default=8,
                   help="decode steps a round (one host readback a round)")
    p.add_argument("--arrival_rounds", type=int, default=12,
                   help="arrivals spread uniformly over this many rounds")
    p.add_argument("--page_size", type=int, default=64)
    p.add_argument("--pool_mb", type=int, default=1024,
                   help="fixed KV-pool budget; the page count derives from "
                        "it, so --kv8 shows its capacity win")
    p.add_argument("--kv8", action="store_true",
                   help="int8 KV pool: half the bytes a page, about twice "
                        "the pages under the same --pool_mb")
    p.add_argument("--spec_k", type=int, default=0,
                   help="self-speculative greedy decoding: K n-gram draft "
                        "tokens verified a forward (exact)")
    p.add_argument("--spec_quantum", type=int, default=1,
                   help="R > 1: R device-drafted verify rounds a host trip")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="chunked prefill: [1, C] continuation forwards")
    p.add_argument("--prefill_batch", type=int, default=1,
                   help="batched wave prefill: chunks of up to W "
                        "admissions share one [W, C] forward (needs "
                        "--prefill_chunk)")
    p.add_argument("--async_rounds", action="store_true",
                   help="pipelined decode rounds (greedy-exact)")
    p.add_argument("--prefix_cache", action="store_true",
                   help="automatic prefix caching of page-aligned prompt "
                        "blocks")
    p.add_argument("--shared_prefix", type=int, default=0,
                   help="one shared S-token instruction prefix before "
                        "every request")
    p.add_argument("--ngram_period", type=int, default=0,
                   help="the induced-bigram checkpoint of models/"
                        "synthetic.py: greedy decode walks a period-P "
                        "token chain, so n-gram acceptance is measurable")
    p.add_argument("--spec_oracle", action="store_true",
                   help="draft with an oracle built from a speculative "
                        "greedy pass (the all-accept upper bound)")
    p.add_argument("--short_gen", type=int, default=0,
                   help="EOS-heavy churn: generation lengths ~ U[1, G] "
                        "instead of --max_new")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="the tiny model and workload (CPU smoke, tests)")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   default=True)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None):
    """The flags with the reference's --synthetic sizes applied."""
    args = parser().parse_args(argv)
    if args.synthetic:
        args.dim, args.layers = 64, 2
        args.slots = 3
        args.requests = 8
        args.min_prompt, args.max_prompt = 4, 12
        args.max_new = 8
        args.step_quantum = 2
        args.arrival_rounds = 4
        args.page_size = 4
        args.pool_mb = 1
    return args


def _on_cpu(device) -> bool:
    return torch.device(device).type == "cpu"


def _max_pages(args) -> int:
    return -(-(args.max_prompt + args.shared_prefix + args.max_new
               + args.step_quantum) // args.page_size)


def model_config(args):
    """The reference's decoder: head_dim 128, a KV head per 4 query heads
    (dim // 512), intermediate dim x 2.6875, vocabulary 32000; bf16 on the
    card, f32 on the plain attention on the CPU. --synthetic: the tiny
    config. Positions reach the pool's context plus a speculative trip."""
    on_cpu = _on_cpu(args.device)
    backend = dict(attn_backend="ref" if on_cpu else None, remat=False)
    dtype = torch.float32 if on_cpu else torch.bfloat16
    if args.synthetic:
        return llama.tiny_config(dtype=dtype, **backend)
    return llama.LlamaConfig(
        vocab_size=VOCAB, dim=args.dim, n_layers=args.layers,
        n_heads=args.dim // 128, n_kv_heads=max(args.dim // 512, 1),
        intermediate=int(args.dim * 2.6875),
        max_seq_len=_max_pages(args) * args.page_size
        + args.spec_quantum * (args.spec_k + 1) + args.step_quantum,
        dtype=dtype, **backend)


def varied_int8_params(cfg, *, seed=0, device="cuda"):
    """The int8 tree of llama.quantize_params(llama.init_params(...)),
    built straight in that form (a bf16 tree at full width would not fit
    beside the pool): int8 codes uniform in [-8, 8], norms 1, the embedding
    N(0, 0.02^2), the quantization scales 0.01."""
    shapes = llama.quantize_params(
        llama.init_params(0, cfg, device="meta"), cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def fill(path, t):
        if isinstance(t, dict):
            return {k: fill(f"{path}/{k}", v) for k, v in t.items()}
        if t.dtype == torch.int8:
            return torch.randint(-8, 9, t.shape, generator=gen,
                                 device=device, dtype=torch.int8)
        if "norm" in path:
            return torch.ones(t.shape, dtype=t.dtype, device=device)
        if "embed" in path:
            return (torch.randn(t.shape, generator=gen, device=device)
                    * 0.02).to(t.dtype)
        return torch.full(t.shape, 0.01, dtype=t.dtype, device=device)

    return fill("", shapes)


def build_model(args):
    """(cfg, params, n_params) on args.device."""
    cfg = model_config(args)
    if args.synthetic:
        params = llama.init_params(args.seed, cfg, device=args.device)
        return cfg, params, count_params(params)
    if args.ngram_period:
        params, _ = synthetic.ngram_quantized_params(
            cfg, period=args.ngram_period, seed=args.seed,
            device=args.device)
        return cfg, params, count_params(params)
    params = varied_int8_params(cfg, seed=args.seed, device=args.device)
    return cfg, params, count_params(params)


def count_params(params) -> int:
    """Weights of the tree: int8 codes and dense leaves one each, a packed
    int4 byte two; quantization scales are not counted."""
    n = 0

    def walk(t):
        nonlocal n
        if quant.is_quantized(t):
            n += t["q"].numel()
        elif quant.is_quantized4(t):
            n += 2 * t["p"].numel()
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            n += t.numel()

    walk(params)
    return n


def weight_tag(params) -> str:
    head = params["lm_head"]
    return ("int4" if quant.is_quantized4(head) else
            "int8" if quant.is_quantized(head) else
            str(head.dtype).replace("torch.", "").replace("bfloat16",
                                                          "bf16"))


def pool_config(args, cfg) -> kv_pool.PagedConfig:
    """The reference's pool: as many pages as --pool_mb holds at this
    model's bytes a page (bf16, or int8 codes with f32 scales under
    --kv8), at least 8."""
    kv_bytes = 1 if args.kv8 else 2
    kd = cfg.n_kv_heads * cfg.head_dim
    page_bytes = 2 * args.page_size * kd * kv_bytes
    if args.kv8:
        page_bytes += 2 * args.page_size * cfg.n_kv_heads * 4
    n_pages = max(int(args.pool_mb * 2 ** 20
                      / (page_bytes * cfg.n_layers)), 8)
    return kv_pool.PagedConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, page_size=args.page_size, n_pages=n_pages,
        max_pages_per_seq=_max_pages(args), slots=args.slots,
        dtype=cfg.dtype, quantize_kv=args.kv8)


def make_workload(args, cfg, rng):
    """[(arrival_round, kind, prompt_len, payload, max_new)], sorted by
    arrival, the reference's draws from rng: kind 'tok' or 'fused',
    arrivals uniform over the first --arrival_rounds rounds.

    --shared_prefix S prepends one S-token instruction prefix to every
    token prompt and one S-row embedding prefix to every fused prompt (the
    protein-serving shape, which --prefix_cache turns into skipped prefill
    and shared pool pages). --short_gen G draws each request's generation
    length from U[1, G]."""
    shared_tok = ([int(t) for t in rng.integers(4, cfg.vocab_size,
                                                args.shared_prefix)]
                  if args.shared_prefix else [])
    shared_emb = (rng.standard_normal(
        (args.shared_prefix, cfg.dim)).astype(np.float32) * 0.02
        if args.shared_prefix else None)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(args.min_prompt, args.max_prompt + 1))
        arrival = int(rng.integers(0, args.arrival_rounds))
        mn = (int(rng.integers(1, args.short_gen + 1))
              if args.short_gen else args.max_new)
        if i % 2 == 0:
            payload = shared_tok + [
                int(t) for t in rng.integers(4, cfg.vocab_size, plen)]
            kind = "tok"
        else:
            tail = rng.standard_normal((plen, cfg.dim)).astype(
                np.float32) * 0.02
            payload = (np.concatenate([shared_emb, tail])
                       if shared_emb is not None else tail)
            kind = "fused"
        reqs.append((arrival, kind, plen + args.shared_prefix, payload,
                     mn))
    return sorted(reqs, key=lambda r: r[0])


def make_batcher(params, cfg, pcfg, args, *, device=None):
    return serving.ContinuousBatcher(
        params, cfg, pcfg, temperature=args.temperature,
        step_quantum=args.step_quantum, seed=args.seed,
        spec_k=args.spec_k, spec_quantum=args.spec_quantum,
        prefill_chunk=args.prefill_chunk or None,
        prefix_cache=args.prefix_cache, prefill_batch=args.prefill_batch,
        async_rounds=args.async_rounds, device=device or args.device)


def _sync(batcher):
    if batcher.device.type == "cuda":
        torch.cuda.synchronize(batcher.device)


def drive(batcher, workload, draft_for=None):
    """Submit by the schedule between ticks until every request is done.
    draft_for: optional {workload index: draft_fn} (oracle mode). Returns
    {lat: submit -> finish seconds a request, util: live share a tick,
    wall, n_tokens, rounds: ticks, round_s: seconds in the ticks that ran
    a round less their admissions, n_rounds: those ticks}."""
    submit_t, finish_t, util = {}, {}, []
    pending = list(enumerate(workload))
    admit_s = [0.0]
    admit = batcher._admit

    def timed_admit():
        t = time.perf_counter()
        admit()
        admit_s[0] += time.perf_counter() - t

    batcher._admit = timed_admit
    round_s, n_rounds, ticks = 0.0, 0, 0
    _sync(batcher)
    t0 = time.perf_counter()
    try:
        while pending or batcher.live or batcher.queue or batcher._inflight:
            while pending and pending[0][1][0] <= ticks:
                i, (_, kind, _, payload, mn) = pending.pop(0)
                dfn = draft_for.get(i) if draft_for else None
                rid = (batcher.submit(payload, max_new=mn, draft_fn=dfn)
                       if kind == "tok" else
                       batcher.submit_fused(payload, max_new=mn,
                                            draft_fn=dfn))
                submit_t[rid] = time.perf_counter()
            had_live = bool(batcher.live)
            t1, a1 = time.perf_counter(), admit_s[0]
            batcher.tick()
            now = time.perf_counter()
            if had_live:
                round_s += (now - t1) - (admit_s[0] - a1)
                n_rounds += 1
            for rid in batcher.done:
                finish_t.setdefault(rid, now)
            util.append(len(batcher.live) / batcher.pcfg.slots)
            ticks += 1
            if ticks >= 100000:
                raise RuntimeError("the serving loop did not converge")
    finally:
        del batcher._admit              # the method again
    _sync(batcher)
    wall = time.perf_counter() - t0
    return dict(lat=np.asarray([finish_t[r] - submit_t[r]
                                for r in submit_t]),
                util=np.asarray(util), wall=wall,
                n_tokens=sum(len(v) for v in batcher.done.values()),
                rounds=ticks, round_s=round_s, n_rounds=n_rounds)


def oracle_drafts(params, cfg, pcfg, args, workload):
    """{workload index: draft_fn} from a speculative greedy pass: each
    request's continuation there, which the timed pass's verify forward
    accepts in full where its logits reproduce."""
    plain = serving.ContinuousBatcher(
        params, cfg, pcfg, temperature=0.0, step_quantum=args.step_quantum,
        seed=args.seed, spec_k=args.spec_k, device=args.device)
    drive(plain, workload)

    def mk_oracle(tokens_list, plen):
        def f(history, k, **kw):
            e = len(history) - plen
            return (tokens_list[e:e + k] + [0] * k)[:k]
        return f

    return {i: mk_oracle(plain.done[i], len(w[3]) if w[1] == "tok" else 0)
            for i, w in enumerate(workload)}


def run(params, cfg, args, *, n_params=None, batcher=None, workload=None,
        warm=None):
    """Serve the workload once on `params` (a decoder tree on
    args.device) and build the JSON line. batcher: one to reuse (reset
    here); workload: make_workload's list (drawn from args.seed when
    None); warm: a workload driven first and thrown away (default: the
    timed one under --warmup, as the reference; False: none). Returns
    {"line", "batcher", "tokens", "drive", "workload"}."""
    on_card = not _on_cpu(args.device)
    pcfg = batcher.pcfg if batcher is not None else pool_config(args, cfg)
    if batcher is None:
        batcher = make_batcher(params, cfg, pcfg, args)
    if workload is None:
        workload = make_workload(args, cfg, np.random.default_rng(args.seed))
    draft_for = None
    if args.spec_k and args.spec_oracle:
        draft_for = oracle_drafts(params, cfg, pcfg, args, workload)
    if warm is None:
        warm = workload if args.warmup else False
    if warm is not False:
        batcher.reset(seed=args.seed)
        drive(batcher, warm, draft_for if warm is workload else None)
    batcher.reset(seed=args.seed)
    d = drive(batcher, workload, draft_for)
    if len(batcher.done) != len(workload):
        raise RuntimeError(f"{len(batcher.done)} of {len(workload)} "
                           "requests finished")
    if n_params is None:
        n_params = count_params(params)
    wall, n_tokens, rounds = d["wall"], d["n_tokens"], d["rounds"]

    def t(x, digits):
        return round(x, digits) if on_card else None

    pc = batcher.pcache.stats if batcher.pcache is not None else None
    result = {
        "metric": "serving_requests_per_sec",
        "value": t(len(workload) / wall, 3),
        "unit": f"requests/sec ({len(workload)} mixed tok+fused reqs, "
                f"~{n_params / 1e9:.1f}B {weight_tag(params)} decoder, "
                f"{args.slots} slots, prompts {args.min_prompt}-"
                f"{args.max_prompt}, max_new {args.max_new}, quantum "
                f"{args.step_quantum})",
        "output_tok_per_sec": t(n_tokens / wall, 1),
        "latency_p50_s": t(float(np.percentile(d["lat"], 50)), 3),
        "latency_p95_s": t(float(np.percentile(d["lat"], 95)), 3),
        "slot_utilization": round(float(d["util"].mean()), 3),
        "ms_per_round": t(d["round_s"] / max(d["n_rounds"], 1) * 1e3, 2),
        "wall_s": t(wall, 2),
        "rounds": rounds,
        "n_tokens": n_tokens,
        "kv_int8": bool(args.kv8),
        "prefill_chunk": args.prefill_chunk,
        "prefill_batch": args.prefill_batch,
        "async_rounds": bool(args.async_rounds),
        "spec_k": args.spec_k,
        **({"spec_accept_per_round": round(
            batcher.spec_stats["emitted"]
            / max(batcher.spec_stats["rounds"], 1), 3),
            "spec_oracle": bool(args.spec_oracle),
            "spec_quantum": args.spec_quantum,
            "spec_round_ms": t(
                wall / max(rounds * args.spec_quantum, 1) * 1e3, 1),
            "spec_ceiling_tok_per_sec": t(
                args.slots * (args.spec_k + 1)
                * max(rounds * args.spec_quantum, 1) / wall, 1)}
           if args.spec_k else {}),
        **({"prefix_cache": True,
            "shared_prefix": args.shared_prefix,
            "prefix_hit_tokens": pc["hit_tokens"],
            "prefix_hit_rate": round(
                pc["hit_tokens"] / max(pc["hit_tokens"] + pc["miss_tokens"],
                                       1), 3),
            "prefix_pages_evicted": pc["evicted"]}
           if pc is not None else
           {"shared_prefix": args.shared_prefix}
           if args.shared_prefix else {}),
        "short_gen": args.short_gen,
        "waste_dropped_tokens": batcher.waste["dropped"],
        "waste_fraction": round(
            batcher.waste["dropped"]
            / max(batcher.waste["emitted"] + batcher.waste["dropped"], 1),
            4),
        "pool_mb_budget": args.pool_mb,
        "n_pages": pcfg.n_pages,
        "concurrency_capacity_tokens": (pcfg.n_pages - 1) * pcfg.page_size,
    }
    if on_card:
        result.update(timing.canary_fields())
        if not args.synthetic:
            result.update(baselines.baseline_fields(
                n_params, args.slots, n_tokens / wall, serving=True))
    else:
        result["timed"] = False
    return {"line": result, "batcher": batcher, "tokens": dict(batcher.done),
            "drive": d, "workload": workload}


def main(argv=None):
    args = parse_args(argv)
    if not _on_cpu(args.device) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed run")
    cfg, params, n_params = build_model(args)
    res = run(params, cfg, args, n_params=n_params)
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    main()
