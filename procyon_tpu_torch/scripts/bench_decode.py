"""Decode throughput: output tokens/sec on one card (counterpart of
scripts/bench_decode.py).

Bulk greedy decode of a Llama-architecture decoder behind the fusion
model's input assembly: B prompts of L tokens prefilled, then one token a
step for every row. Two-point timing over generation lengths (`gen_small`
and `gen_big` steps, the best of two runs each) cancels the prefill and
the final wait. The steps are stepped from the host with nothing read back
until a run's end.

The decoder follows the reference's rule: head_dim 128, a KV head per two
query heads (dim // 256), intermediate dim x 2.6875, vocabulary 32000,
bf16. The default is a ~0.9B decoder (dim 2048, 16 layers); `--dim 4096
--layers 32` has ProCyon-Split's Llama-2-7B dim and depth (by the rule,
16 KV heads where Llama-2-7B has 32). bf16 weights are seeded
random; `--quant --bits 8|4` weights are constants (int8 codes 1, floats
0.01; the time does not depend on their values) built straight in their
quantized form, and the line then carries the quantization quality probe
(evaluate/quant_quality.probe: logit cosine and CE delta against bf16 on
its own seeded decoder), exiting 1 when its gate fails.

    python -m procyon_tpu_torch.scripts.bench_decode [--dim 4096
        --layers 32 --batch 16 --prompt_len 256] [--paged [--kv8]]
        [--quant --bits 4]

`--paged` decodes on the paged KV pool (the serving path,
llama.paged_forward) instead of the dense per-request cache. On the card
the prefill's attention is the flash forward (csrc/flash_attention_fwd.cu),
a paged decode step on a bf16 pool of at least 512 tokens a slot (prompt +
gen_big + 8 >= 449) the paged attention (csrc/paged_attention.cu), and
`--bits 4` products of at most 256 rows the int4 matmul
(csrc/int4_matmul.cu). It prints one JSON line,
`decode_tokens_per_sec_chip`, with the estimated A100 denominators and the
card's name, power limit and canary. `--device cpu` decodes in f32 and
times nothing. `main(argv)` returns the result as a dict; `bench_config`,
`build_params`, `prompt_batch`, `decoder` and `run` are the pieces a
caller with its own weights uses.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.evaluate import quant_quality
from procyon_tpu_torch.inference import kv_pool
from procyon_tpu_torch.models import llama, unified
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.utils import baselines, timing

VOCAB = 32000


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--prompt_len", type=int, default=256)
    p.add_argument("--gen_small", type=int, default=32)
    p.add_argument("--gen_big", type=int, default=96)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--quant", action="store_true",
                   help="weight-only quantization (ops/quant.py)")
    p.add_argument("--bits", type=int, default=8, choices=(4, 8),
                   help="weight quantization width (4 = packed int4)")
    p.add_argument("--quality", action="store_true", default=True,
                   help="run the quantization quality probe and gate the "
                        "result")
    p.add_argument("--no-quality", dest="quality", action="store_false")
    p.add_argument("--paged", action="store_true",
                   help="decode on the paged KV pool (the serving path) "
                        "instead of the dense per-request cache")
    p.add_argument("--page_size", type=int, default=64)
    p.add_argument("--kv8", action="store_true",
                   help="int8 KV pool with per-token-per-head scales "
                        "(paged only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.kv8 and not args.paged:
        p.error("--kv8 requires --paged (the dense cache has no "
                "quantized variant)")
    if args.dim < 128 or args.dim % 128:
        p.error(f"--dim must be a multiple of 128 (head_dim=128), "
                f"got {args.dim}")
    return args


def bench_config(dim, layers, max_seq_len, *, device="cuda"):
    """The reference's decoder (bf16 on the card, f32 on the plain
    attention on the CPU) inside a fusion config without an encoder."""
    on_cpu = torch.device(device).type == "cpu"
    dtype = torch.float32 if on_cpu else torch.bfloat16
    return unified.UnifiedConfig(
        llama=llama.LlamaConfig(
            vocab_size=VOCAB, dim=dim, n_layers=layers,
            n_heads=dim // 128, n_kv_heads=max(dim // 256, 1),
            intermediate=int(dim * 2.6875), max_seq_len=max_seq_len,
            dtype=dtype, attn_backend="ref" if on_cpu else None,
            remat=False),
        esm=None, protein_embed_dim=64, token_projector_layers=1,
        token_projector_hidden=64, retrieval_dim=64, dtype=dtype)


def constant_quantized_params(cfg, bits, device):
    """The tree of unified.init_params with its decoder quantized to
    `bits` (shapes and dtypes built on "meta"), every int8 byte 1 and every
    float 0.01."""
    shapes = unified.init_params(0, cfg, device="meta")
    shapes["llama"] = llama.quantize_params(shapes["llama"], cfg.llama,
                                            bits=bits)
    return bridge.map_tensors(
        lambda t: torch.full(t.shape, 1 if t.dtype == torch.int8 else 0.01,
                             dtype=t.dtype, device=device), shapes)


def build_params(cfg, args):
    """(params, n_params, weight tag): seeded weights in the config's
    dtype, or constant quantized ones under --quant. n_params counts the
    unquantized decoder's."""
    n_params = sum(t.numel() for t in bridge.tree_leaves(
        unified.init_params(0, cfg, device="meta")["llama"]))
    if args.quant:
        return (constant_quantized_params(cfg, args.bits, args.device),
                n_params, f"int{args.bits}")
    return (unified.init_params(args.seed, cfg, device=args.device),
            n_params, "bf16" if cfg.dtype == torch.bfloat16 else "f32")


def prompt_batch(cfg, B, L, *, device="cuda", seed=0):
    """B random prompts of L tokens (the reference's draws), no soft
    tokens."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    return {
        "input_ids": torch.as_tensor(
            rng.integers(4, cfg.llama.vocab_size, (B, L)),
            dtype=torch.int32, device=dev),
        "seg_ids": torch.ones((B, L), dtype=torch.int32, device=dev),
        "positions": torch.arange(L, dtype=torch.int32,
                                  device=dev).expand(B, L).contiguous(),
        "soft_map": torch.full((B, L), -1, dtype=torch.int32, device=dev),
        "protein_embeds": torch.zeros((1, cfg.protein_embed_dim),
                                      dtype=torch.float32, device=dev),
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decoder(params, cfg, batch, max_len, *, paged=False, page_size=64,
            kv8=False):
    """run(n) -> (tokens [B, n + 1], seconds of the n steps): a fresh cache
    (or pool), the prefill and its greedy token, then n greedy one-token
    steps, synchronized before and after the steps."""
    B, L = batch["input_ids"].shape
    dev = batch["input_ids"].device
    lcfg = cfg.llama
    head = params["llama"]["lm_head"]

    if paged:
        n_pages_seq = -(-max_len // page_size)
        pcfg = kv_pool.PagedConfig(
            n_layers=lcfg.n_layers, n_kv_heads=lcfg.n_kv_heads,
            head_dim=lcfg.head_dim, page_size=page_size,
            n_pages=1 + B * n_pages_seq, max_pages_per_seq=n_pages_seq,
            slots=B, dtype=lcfg.dtype, quantize_kv=kv8)
        alloc = kv_pool.PageAllocator(pcfg)
        table = torch.as_tensor(
            np.stack([alloc.allocate(s, max_len) for s in range(B)]),
            dtype=torch.int32, device=dev)
        slots = torch.arange(B, device=dev)
        last = torch.full((B,), L - 1, dtype=torch.long, device=dev)

        def prefill():
            pool = kv_pool.init_pool(pcfg, device=dev)
            pool["page_table"] = table.clone()
            logits, pool = llama.paged_forward(
                params["llama"], lcfg, pool, pcfg, slots,
                input_embeds=unified.assemble_input_embeds(params, cfg,
                                                           batch),
                seg_ids=batch["seg_ids"], logits_at=last,
                max_position=L - 1)
            return logits[:, -1].argmax(-1), pool

        def step(tok, pool, t):
            logits, pool = llama.paged_forward(
                params["llama"], lcfg, pool, pcfg, slots,
                tokens=tok[:, None], max_position=L + t)
            return logits[:, -1].argmax(-1), pool
    else:
        seg_live = batch["seg_ids"][:, -1:]

        def prefill():
            cache = llama.init_kv_cache(lcfg, B, max_len=max_len, device=dev)
            out = unified.forward(params, cfg, batch, kv_cache=cache,
                                  want_logits=False, max_position=L - 1)
            nxt = quant.mm(out["hidden"][:, -1], head).float().argmax(-1)
            return nxt, (out["kv_cache"], batch["positions"][:, -1:] + 1)

        def step(tok, state, t):
            cache, pos = state
            out = llama.forward(params["llama"], lcfg, tokens=tok[:, None],
                                seg_ids=seg_live, positions=pos,
                                kv_cache=cache, max_position=L + t)
            return out["logits"][:, -1].argmax(-1), (out["kv_cache"],
                                                     pos + 1)

    @torch.no_grad()
    def run(n):
        tok, state = prefill()
        toks = [tok]
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(n):
            tok, state = step(tok, state, t)
            toks.append(tok)
        _sync(dev)
        return torch.stack(toks, 1), time.perf_counter() - t0

    return run


def run(params, cfg, args, *, n_params, wtag):
    """The two-point decode time on the card (tokens only on the CPU) and
    the JSON line. Returns {"line", "tokens", "gate_failed"}."""
    on_card = torch.device(args.device).type == "cuda"
    batch = prompt_batch(cfg, args.batch, args.prompt_len,
                         device=args.device, seed=args.seed)
    max_len = args.prompt_len + args.gen_big + 8
    go = decoder(params, cfg, batch, max_len, paged=args.paged,
                 page_size=args.page_size, kv8=args.kv8)
    tokens, _ = go(2)                    # the first launches, and a warm-up
    per_step = None
    if on_card:
        t_small = min(go(args.gen_small)[1] for _ in range(2))
        t_big = min(go(args.gen_big)[1] for _ in range(2))
        per_step = (t_big - t_small) / (args.gen_big - args.gen_small)
    wtag_paged = wtag + (", paged" if args.paged else "")
    result = {
        "metric": "decode_tokens_per_sec_chip",
        "value": round(args.batch / per_step, 1) if on_card else None,
        "unit": f"tok/s (B{args.batch}, ~{n_params / 1e9:.1f}B params, "
                f"{wtag_paged})",
        "per_step_ms": round(per_step * 1e3, 2) if on_card else None,
        "backend": "paged" if args.paged else "dense",
        "kv_int8": bool(args.kv8 and args.paged),
    }
    if on_card:
        result.update(baselines.baseline_fields(
            float(n_params), args.batch, args.batch / per_step))
    gate_failed = False
    if args.quality and args.quant:
        q = quant_quality.probe(args.bits, "dequant", device=args.device)
        result.update(q.as_dict())
        gate_failed = not q.passed
    result.update(timing.canary_fields() if on_card else {"timed": False})
    return {"line": result, "tokens": tokens, "gate_failed": gate_failed}


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the "
                           "untimed run")
    cfg = bench_config(args.dim, args.layers,
                       args.prompt_len + args.gen_big + 32,
                       device=args.device)
    params, n_params, wtag = build_params(cfg, args)
    res = run(params, cfg, args, n_params=n_params, wtag=wtag)
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    sys.exit(1 if main()["gate_failed"] else 0)
