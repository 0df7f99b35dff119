#!/usr/bin/env python3
"""Smoke run of procyon_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from procyon_tpu_torch/csrc, then:
  1. prints the card (nvidia-smi name, power limit) and the build time;
  2. holds each kernel against its plain PyTorch version on the card, in
     bf16 at ESM2-650M widths (a small batch, then one layer of the B64 x
     L512 batch), and times both with CUDA events;
  3. drives the protein-embedding path at full ESM2-650M width (33 layers,
     dim 1280, W8A8, fused QKV, seeded random weights): ~64 proteins of
     50-1500 residues split into 512-token rows, `protein_embed_fn`
     (encode, pool, regroup, shared projector), a check that each kernel
     ran once per layer, the W8A8-vs-bf16 cosine, a small-input check
     against the plain path on the CPU in f32, and cosine top-k queries;
  4. prints proteins/s for bf16 and W8A8 at B64, L512.

Stdout ends with a JSON line of per-kernel results, the card's nvidia-smi
line, and `{"ok": true, "device": {...}}`. Any failed check exits non-zero.
There is no CPU path: without CUDA it exits with status 2.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# kernel checks at ESM2-650M widths: a small batch, then one layer of the
# main path's B64 x L512 batch (the shapes the timed forward gives them)
ATTN_SHAPE = dict(S=512, H=20, D=64)
ATTN_BATCHES = (4, 64)
MLP_SHAPE = dict(d=1280, H=5120)
MLP_ROWS = (4096, 64 * 512)
# bf16 outputs: |kernel - plain| <= ATOL + RTOL * |plain|, RTOL one bf16
# ulp (2^-7 of the value). The attention kernel's online softmax rounds P
# to bf16 against a running max, the plain version against the row max;
# in the MLP an int8 rounding tie may take the neighbouring code, which
# the mean error bounds
ATOL = 2e-2
RTOL = 2.0 ** -7
MLP_MEAN_TOL = 2e-3
QUALITY_GATE_COS = 0.999   # bench.py's gate, printed beside cos_min
SANITY_COS = 0.99          # random weights: asserted bound


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def within_tol(out, ref):
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs() <= ATOL + RTOL * ref.abs()).all().item())


def cuda_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain):
    """Times in turns (plain, kernel, kernel, plain); means of the pairs."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_build():
    from procyon_tpu_torch.ops import _build
    t0 = time.perf_counter()
    for name in ("rowblock_attention", "fused_ln_mlp_int8"):
        _build.build(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_DIR})")


def phase_attention(dev, B):
    import torch
    from procyon_tpu_torch.ops import attention_rowblock as rb
    from procyon_tpu_torch.ops.rotary import flat_rotary_tables
    S, H, D = (ATTN_SHAPE[k] for k in "SHD")
    HD = H * D
    g = torch.Generator(device=dev).manual_seed(SEED)
    qkv = torch.randn((B, S, 3 * HD), generator=g, device=dev).to(
        torch.bfloat16)
    seg = torch.ones((B, S), dtype=torch.int32, device=dev)
    seg[0, S - 100:] = 0          # padded tail
    seg[1] = 0                    # fully padded row: dead
    seg[2, S // 2:] = 2           # a second packed segment
    cos, sin, _ = flat_rotary_tables(D, H, S)
    rope = tuple(t.to(dev, torch.bfloat16) for t in (cos, sin, cos, sin))
    sm = 1.0 / math.sqrt(D)
    folded = tuple(t.contiguous() for t in rb.fold_rope(rope, sm))
    q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]

    def kernel():
        return rb.rowblock_packed_qkv_fwd(qkv, seg, n_heads=H, head_dim=D,
                                          sm_scale=sm, rope=rope)

    def plain():
        return rb.rowblock_attention_ref(q, k, v, seg, head_dim=D,
                                         score_scale=1.0, rope=folded)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "attention: non-finite")
    check(not out[1].any().item(), "attention: dead row is not zero")
    check(within_tol(out, ref), f"attention max_abs_err {err}")
    # the unpacked route: no rotary in the kernel, scale on the scores
    sc = sm * rb.LOG2E
    out2 = rb.rowblock_attention(q, k, v, seg, head_dim=D, score_scale=sc)
    ref2 = rb.rowblock_attention_ref(q, k, v, seg, head_dim=D,
                                     score_scale=sc)
    err2 = (out2.float() - ref2.float()).abs().max().item()
    check(within_tol(out2, ref2), f"attention (no rotary) err {err2}")
    ms, plain_ms = paired_ms(kernel, plain)
    print(f"attention B{B} S{S} H{H} D{D}: max_abs_err {err:.3e} "
          f"(no rotary {err2:.3e}; tol {ATOL} + {RTOL}|plain|); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return dict(name="rowblock_attention", route="cuda",
                source="procyon_tpu_torch/csrc/rowblock_attention.cu",
                replaces="procyon_tpu/ops/attention_rowblock.py:159",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_mlp(dev, M):
    import torch
    from procyon_tpu_torch.ops import fused_mlp as fm
    from procyon_tpu_torch.ops import quant
    d, H = MLP_SHAPE["d"], MLP_SHAPE["H"]
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x = randn(M, d).to(torch.bfloat16)
    lnw = (1 + randn(d, scale=0.1)).to(torch.bfloat16)
    lnb = randn(d, scale=0.1).to(torch.bfloat16)
    w1 = quant.quantize(randn(d, H, scale=d ** -0.5))
    w2 = quant.quantize(randn(H, d, scale=H ** -0.5))
    b1 = randn(H, scale=0.1).to(torch.bfloat16)
    b2 = randn(d, scale=0.1).to(torch.bfloat16)
    args = (x, lnw, lnb, w1["q"], w1["s"], b1, w2["q"], w2["s"], b2)
    errs = []
    for residual in (False, True):
        out = fm.fused_ln_mlp_int8(*args, add_residual=residual)
        ref = fm.fused_ln_mlp_int8_ref(*args, add_residual=residual)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        check(torch.isfinite(out.float()).all().item(), "mlp: non-finite")
        errs.append(diff.max().item())
        check(within_tol(out, ref) and diff.mean().item() <= MLP_MEAN_TOL,
              f"mlp (residual={residual}): max_abs_err {errs[-1]}, mean "
              f"{diff.mean().item()}")
    ms, plain_ms = paired_ms(
        lambda: fm.fused_ln_mlp_int8(*args, add_residual=True),
        lambda: fm.fused_ln_mlp_int8_ref(*args, add_residual=True))
    print(f"fused mlp M{M} d{d} H{H} G{fm.requant_group(H)}: max_abs_err "
          f"{errs[0]:.3e} / {errs[1]:.3e} (no residual / residual; tol "
          f"{ATOL} + {RTOL}|plain|, mean {MLP_MEAN_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(name="fused_ln_mlp_int8", route="cuda",
                source="procyon_tpu_torch/csrc/fused_ln_mlp_int8.cu",
                replaces="procyon_tpu/ops/fused_mlp.py:35",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def random_proteins(lengths, rng):
    aa = "ACDEFGHIKLMNPQRSTVWY"
    return ["".join(aa[i] for i in rng.integers(0, 20, n)) for n in lengths]


def cosines(a, b):
    import torch
    a, b = a.float(), b.float()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-8)


def serving_params(params, cfg):
    from procyon_tpu_torch.models import esm2
    out = dict(params)
    out["esm"] = esm2.fuse_qkv_params(esm2.quantize_params(params["esm"],
                                                           cfg.esm))
    return out


def phase_small_reference(dev):
    """The card's W8A8 path (both kernels, bf16) against the plain path on
    the CPU in f32 (held to procyon_tpu by tests/test_torch_unified.py), on
    the same weights and proteins: ESM2-650M widths cut to 2 layers, 3
    proteins (one split in two) in 4 rows of 512 tokens."""
    import numpy as np
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.data import protein_tokenizer as tok
    from procyon_tpu_torch.models import esm2, unified
    from procyon_tpu_torch.ops import attention_rowblock, fused_mlp
    ecfg = esm2.esm2_config("650m", n_layers=2, max_seq_len=512,
                            attn_backend="rowblock", quant_mode="w8a8",
                            dtype=torch.bfloat16)
    cfg = unified.UnifiedProteinConfig(esm=ecfg)
    params = serving_params(unified.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 2), cfg), cfg)
    pb = tok.batch_encode(random_proteins((300, 700, 120),
                                          np.random.default_rng(1)),
                          max_len=510)
    check(pb.tokens.shape == (4, 512), f"rows {pb.tokens.shape}")
    args = [torch.from_numpy(a) for a in (pb.tokens, pb.group_ids,
                                          pb.row_valid)]
    fn = unified.protein_embed_fn(cfg)
    before = (attention_rowblock.launches, fused_mlp.launches)
    gpu = fn(params, *(a.to(dev) for a in args), pb.num_groups)
    check(attention_rowblock.launches - before[0] == ecfg.n_layers
          and fused_mlp.launches - before[1] == ecfg.n_layers,
          "small check: the card run did not take both kernels")
    cfg32 = dataclasses.replace(cfg, esm=dataclasses.replace(
        ecfg, dtype=torch.float32), dtype=torch.float32)
    p32 = bridge.to_torch(bridge.to_numpy(params), device="cpu")
    t0 = time.perf_counter()
    cpu = unified.protein_embed_fn(cfg32)(p32, *args, pb.num_groups)
    cos = cosines(gpu.cpu(), cpu).min().item()
    print(f"small input (650M widths, 2 layers, W8A8, 3 proteins): card "
          f"bf16 vs CPU f32 plain path cos_min {cos:.6f} (CPU run "
          f"{time.perf_counter() - t0:.1f} s)")
    check(cos >= SANITY_COS, f"small-input cos_min {cos} < {SANITY_COS}")


def phase_main_path(dev):
    import numpy as np
    import torch
    from procyon_tpu_torch.data import protein_tokenizer as tok
    from procyon_tpu_torch.inference.prompts import \
        get_proteins_from_embedding
    from procyon_tpu_torch.models import esm2, unified
    from procyon_tpu_torch.ops import attention_rowblock, fused_mlp
    ecfg = esm2.esm2_config("650m", max_seq_len=512, dtype=torch.bfloat16,
                            attn_backend="rowblock")
    cfg = unified.UnifiedProteinConfig(esm=ecfg)
    t0 = time.perf_counter()
    params = unified.init_params(
        torch.Generator(device=dev).manual_seed(SEED), cfg)
    cfg8 = dataclasses.replace(cfg, esm=dataclasses.replace(
        ecfg, quant_mode="w8a8"))
    params8 = serving_params(params, cfg8)
    torch.cuda.synchronize()
    print(f"main path: ESM2-650M ({ecfg.n_layers} layers, dim {ecfg.dim}), "
          f"random weights (seed {SEED}) in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(50, 1501, 64)
    lengths[0] = 1500             # at least one full 510-residue chunk
    seqs = random_proteins(lengths, rng)
    pb = tok.batch_encode(seqs, max_len=510)
    R, S = pb.tokens.shape
    check(S == 512, f"rows are {S} wide, expected 512")
    args = [torch.from_numpy(a).to(dev) for a in (pb.tokens, pb.group_ids,
                                                  pb.row_valid)]
    print(f"  {len(seqs)} proteins -> {R} rows of {S} tokens "
          f"({R - len(seqs)} extra rows from chunk splits)")

    attention_rowblock.launches = 0
    fused_mlp.launches = 0
    t0 = time.perf_counter()
    emb8 = unified.protein_embed_fn(cfg8)(params8, *args, pb.num_groups)
    torch.cuda.synchronize()
    t8 = time.perf_counter() - t0
    launches = {"rowblock_attention": attention_rowblock.launches,
                "fused_ln_mlp_int8": fused_mlp.launches}
    print(f"  W8A8 forward {t8:.3f} s; kernel launches {launches}")
    check(all(n == ecfg.n_layers for n in launches.values()),
          f"expected {ecfg.n_layers} launches of each kernel: {launches}")
    check(tuple(emb8.shape) == (len(seqs), cfg.retrieval_dim),
          f"embedding shape {tuple(emb8.shape)}")
    check(torch.isfinite(emb8.float()).all().item(), "non-finite W8A8")

    before = attention_rowblock.launches
    embbf = unified.protein_embed_fn(cfg)(params, *args, pb.num_groups)
    torch.cuda.synchronize()
    check(attention_rowblock.launches - before == ecfg.n_layers,
          "bf16 path did not run the attention kernel once per layer")
    check(torch.isfinite(embbf.float()).all().item(), "non-finite bf16")
    cos = cosines(emb8, embbf)
    cos_min = cos.min().item()
    print(f"  W8A8 vs bf16 per-protein cosine: cos_min {cos_min:.6f} "
          f"(bench.py gate {QUALITY_GATE_COS}; asserted >= {SANITY_COS})")
    check(cos_min >= SANITY_COS, f"cos_min {cos_min} < {SANITY_COS}")

    table = emb8.float().cpu().numpy()
    for qi in (0, 17, 42, 63):
        top = get_proteins_from_embedding(table, table[qi], top_k=5)
        print(f"  query protein {qi}: top-5 "
              f"{[(r['protein_id'], round(r['score'], 4)) for r in top]}")
        check(top[0]["protein_id"] == qi and abs(top[0]["score"] - 1) < 1e-3,
              f"query {qi} does not rank itself first: {top[0]}")
    return launches, cos_min, (params, params8, cfg, cfg8)


def phase_throughput(dev, params, params8, cfg, cfg8, batch=64, seq_len=512,
                     reps=3):
    """bench.py's workload: B64 rows of L512 with random lengths in
    [L/2, L-2), ESM2 forward + mean pooling; host clock around
    synchronized runs after one warm-up."""
    import numpy as np
    import torch
    from procyon_tpu_torch.models import esm2, pooling
    rng = np.random.default_rng(SEED)
    tokens = np.full((batch, seq_len), esm2.PAD_IDX, np.int64)
    for i, n in enumerate(rng.integers(seq_len // 2, seq_len - 2, batch)):
        tokens[i, 0] = esm2.CLS_IDX
        tokens[i, 1:n + 1] = rng.integers(4, 24, n)
        tokens[i, n + 1] = esm2.EOS_IDX
    tokens = torch.from_numpy(tokens).to(dev)
    mask = (tokens != esm2.PAD_IDX).to(torch.int32)

    def embed(p, c):
        return pooling.pool_tokens(esm2.forward(p, c, tokens)["hidden"],
                                   mask, "mean")

    rates, embs = {}, {}
    for name, p, c in (("bf16", params["esm"], cfg.esm),
                       ("w8a8", params8["esm"], cfg8.esm)):
        embs[name] = embed(p, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            embed(p, c)
        torch.cuda.synchronize()
        rates[name] = batch * reps / (time.perf_counter() - t0)
    cos_min = cosines(embs["w8a8"], embs["bf16"]).min().item()
    print(f"throughput B{batch} L{seq_len}: bf16 {rates['bf16']:.2f} "
          f"proteins/s, W8A8 {rates['w8a8']:.2f} proteins/s; pooled-hidden "
          f"cos_min {cos_min:.6f} (bench.py's metric)")
    return rates, cos_min


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run has no CPU path",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "procyon_tpu_torch")):
        print("chip_smoke: procyon_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    # the JSON line carries the results at the main path's shapes (last)
    kernels = [[phase_attention(dev, b) for b in ATTN_BATCHES][-1],
               [phase_mlp(dev, m) for m in MLP_ROWS][-1]]
    phase_small_reference(dev)
    launches, cos_min, state = phase_main_path(dev)
    rates, bench_cos = phase_throughput(dev, *state)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {
        "model": "esm2-650m W8A8 fused-QKV", "cos_min_retrieval": cos_min,
        "cos_min_pooled_b64": bench_cos,
        "proteins_per_sec_bf16": rates["bf16"],
        "proteins_per_sec_w8a8": rates["w8a8"]}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
