#!/usr/bin/env python3
"""Smoke run of procyon_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from procyon_tpu_torch/csrc (one nvcc per
source, all started together), then:
  1. prints the card (nvidia-smi name, power limit) and the build time;
  2. holds each kernel against its plain PyTorch version on the card in
     bf16 and times kernel, plain version and, where there is one, the one
     PyTorch call that computes the same function (CUDA events): the
     row-block attention and the fused LN + int8 MLP at ESM2-650M widths;
     the flash forward at Llama-3-8B widths (Hq 32, Hkv 8, D 128, causal)
     for the /retrieve request's B1 x 512 and for B4 and B16 with a
     left-padded, a dead and a packed row, at a cache shape (64 new tokens
     over 1024 slots, positions given), and through rowblock_fwd at
     ESM2-35M's shape (H 20, D 24, with log-sum-exp);
  3. drives the protein-embedding path at full ESM2-650M width (33 layers,
     W8A8, fused QKV, seeded random weights), as before: kernel launches
     per layer, the W8A8-vs-bf16 cosine, a small-input check against the
     plain path on the CPU in f32, cosine top-k queries, proteins/s;
     then ESM2-35M (head_dim 24, outside the packed row-block kernel) at
     full depth on B16 x 512 tokens with attn_backend="rowblock": one
     launch of the flash kernel's source per layer, hidden states against
     the plain path on the CPU in f32;
  4. checks the fusion path (prompt -> soft tokens -> Llama -> [PROT] ->
     lm projector) at ProCyon-Full widths cut to 2 layers on the card in
     bf16 against the plain path on the CPU in f32. For this check only,
     the vocabulary is cut to 8192;
  5. drives /retrieve at ProCyon-Full width (Llama-3-8B, 32 layers, vocab
     128256, 20000 synthetic proteins): builds the service on the card,
     starts the stdlib HTTP server on a free port, POSTs five descriptions,
     checks each answer and that each request launched the flash kernel
     once per layer, then prints queries/s for `service.retrieve` and for
     `retrieval_query_embedding` at B16 x 512 tokens.

Each kernel's least possible time (`bound_ms`) is the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak for their type (989 TFLOP/s bf16, 1979 TOP/s
int8); an attention kernel's operations count the (query, key) pairs this
run's masks allow, and its bytes the q, k and v rows that are not padding.
--profile adds one torch.profiler trace of a request.

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
import threading
import time
import urllib.request

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
# the flash forward at Llama-3-8B widths; the /retrieve request is B1
FLASH_SHAPE = dict(S=512, Hq=32, Hkv=8, D=128)
FLASH_BATCHES = (1, 4, 16)
FLASH_CACHE = dict(B=4, Sq=64, Skv=1024, filled=700)
ESM35M_SHAPE = dict(B=16, S=512, H=20, D=24)
# the library call rounds elsewhere (no bf16 P, the scale applied to q), so
# it is held to the kernel only loosely, as a check of the mask it was given
LIBRARY_ATOL = 5e-2
LSE_TOL = 1e-3             # f32 log-sum-exp, kernel vs plain
# published peaks of the H100 SXM (dense): bytes/s, bf16 FLOP/s, int8 OP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
RETRIEVE_DESCRIPTIONS = (
    ("disgenet", "progressive neurological decline with seizures"),
    ("omim", "early onset cardiomyopathy with conduction defects"),
    ("disgenet", "impaired glucose tolerance and insulin resistance"),
    ("omim", "recurrent infections caused by a defect of neutrophil "
             "function and delayed wound healing"),
    ("disgenet", "retinal degeneration with night blindness"),
)
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


def bound(n_bytes, ops, peak_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def live_bytes(t, seg):
    """Bytes of the rows of t [B, S, ...] whose segment id is not 0: a
    padded row's values cannot change the result, so the function need not
    read them."""
    return int((seg > 0).sum().item()) * t[0, 0].numel() * t.element_size()


def allowed_pairs(seg_q, seg_kv, causal=False, q_pos=None, kv_pos=None):
    """The number of (query, key) pairs the masks allow, over the batch."""
    import torch
    ok = (seg_q[:, :, None] == seg_kv[:, None, :]) & (seg_q[:, :, None] > 0)
    if causal:
        if q_pos is None:
            q_pos = torch.arange(seg_q.shape[1], device=seg_q.device)[None]
            kv_pos = torch.arange(seg_kv.shape[1], device=seg_q.device)[None]
        ok = ok & (q_pos[:, :, None] >= kv_pos[:, None, :])
    return int(ok.sum().item()), ok


def sdpa_ms(q, k, v, ok, kernel_out):
    """Time F.scaled_dot_product_attention (the library call, used nowhere
    in the port) on q [B, Sq, Hq, D], k / v [B, Skv, Hkv, D] under the
    boolean mask ok [B, Sq, Skv]; its live rows must agree with the
    kernel's."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = ok[:, None]
    gqa = qt.shape[1] != kt.shape[1]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=gqa)

    lib = call().transpose(1, 2)
    live = ok.any(-1)
    diff = (lib[live].float() - kernel_out[live].float()).abs().max().item()
    check(diff <= LIBRARY_ATOL, "scaled_dot_product_attention is "
          f"{diff} from the kernel on live rows (> {LIBRARY_ATOL})")
    return cuda_ms(call)


def phase_build():
    from procyon_tpu_torch.ops import _build
    names = ("rowblock_attention", "fused_ln_mlp_int8", "flash_attention_fwd")
    t0 = time.perf_counter()
    errors = {}

    def build(name):
        try:
            _build.build(name)
        except Exception as e:   # reported below, in the main thread
            errors[name] = e

    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in names:
        check(name not in errors, f"{name} did not build: "
                                  f"{errors.get(name)}")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(names)} sources "
          f"in parallel ({_build.BUILD_DIR})")


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
    cos, sin = (t.to(dev, torch.bfloat16)
                for t in flat_rotary_tables(D, H, S)[:2])
    rope = (cos, sin, cos, sin)
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
    # the library call: attention on pre-rotated q / k under the same mask
    pairs, ok = allowed_pairs(seg, seg)
    from procyon_tpu_torch.ops.rotary import apply_rope_flat
    q4 = apply_rope_flat(q, rope[0], rope[1], D).reshape(B, S, H, D)
    k4 = apply_rope_flat(k, rope[2], rope[3], D).reshape(B, S, H, D)
    library_ms = sdpa_ms(q4, k4, v.reshape(B, S, H, D), ok,
                         out.reshape(B, S, H, D))
    # the k-side tables are the q-side's: cos and sin are read once
    n_bytes = live_bytes(qkv, seg) + nbytes(seg, out, cos, sin)
    ops = 4 * D * H * pairs
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_BF16)
    print(f"attention B{B} S{S} H{H} D{D}: max_abs_err {err:.3e} "
          f"(no rotary {err2:.3e}; tol {ATOL} + {RTOL}|plain|); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.2f} GFLOP "
          f"over {pairs} allowed pairs, {n_bytes / 1e6:.1f} MB)")
    return dict(name="rowblock_attention", route="cuda",
                source="procyon_tpu_torch/csrc/rowblock_attention.cu",
                replaces="procyon_tpu/ops/attention_rowblock.py:274",
                shape=f"B{B} S{S} H{H} D{D}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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
    n_bytes = nbytes(*args) + nbytes(out)
    ops = 4 * M * d * H            # two int8 products of 2*M*d*H each
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_INT8)
    print(f"fused mlp M{M} d{d} H{H} G{fm.requant_group(H)}: max_abs_err "
          f"{errs[0]:.3e} / {errs[1]:.3e} (no residual / residual; tol "
          f"{ATOL} + {RTOL}|plain|, mean {MLP_MEAN_TOL}); kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({ops / 1e9:.1f} GOP, {n_bytes / 1e6:.1f} MB); no "
          f"single PyTorch call computes it")
    return dict(name="fused_ln_mlp_int8", route="cuda",
                source="procyon_tpu_torch/csrc/fused_ln_mlp_int8.cu",
                replaces="procyon_tpu/ops/fused_mlp.py:368",
                shape=f"M{M} d{d} H{H}", max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def flash_case(name, q, k, v, seg_q, seg_kv, *, causal, q_pos=None,
               kv_pos=None, through_rowblock=False):
    """One shape of the flash kernel: against its plain version (out, and
    lse on live rows), dead rows exactly 0, times for kernel, plain version
    and the library call, and the bound from this run's masks (operations
    over the allowed pairs; bytes of the live q, k and v rows, of out, lse
    and the four int arrays)."""
    import torch
    from procyon_tpu_torch.ops import attention_rowblock as rb
    from procyon_tpu_torch.ops import flash_attention as fa
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    sm = 1.0 / math.sqrt(D)
    ints = fa.mask_inputs(q, k, seg_q, seg_kv, q_pos, kv_pos)
    bounded = q_pos is None and Sq == Skv

    def kernel():
        if through_rowblock:
            return rb.rowblock_fwd(q, k, v, *ints, causal=causal,
                                   sm_scale=sm, bounded=bounded,
                                   want_lse=True)
        return fa.flash_fwd(q, k, v, *ints, causal=causal, sm_scale=sm,
                            bounded=bounded, want_lse=True)

    def plain():
        return fa.flash_fwd_ref(q, k, v, *ints, causal=causal, sm_scale=sm)

    before = fa.launches
    (out, lse), (ref, ref_lse) = kernel(), plain()
    torch.cuda.synchronize()
    check(fa.launches == before + 1, f"{name}: the wrapper did not launch")
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite")
    check(within_tol(out, ref), f"{name}: max_abs_err {err}")
    live = ref_lse > -1e29
    check(torch.equal(lse > -1e29, live)
          and bool((lse[~live] == -1e30).all().item()),
          f"{name}: dead rows' lse is not -1e30")
    lse_err = (lse[live] - ref_lse[live]).abs().max().item()
    check(lse_err <= LSE_TOL, f"{name}: lse err {lse_err}")
    dead = ~live.permute(0, 2, 1)                       # [B, Sq, Hq]
    check(not out[dead].any().item(), f"{name}: a dead row is not zero")
    # through the public entry too (no lse): the same kernel, the same out
    if not through_rowblock:
        pub = fa.flash_attention(q, k, v, seg_q, seg_kv, causal=causal,
                                 q_positions=q_pos, kv_positions=kv_pos)
        check(torch.equal(pub, out), f"{name}: flash_attention differs")
    ms, plain_ms = paired_ms(kernel, plain)
    pairs, ok = allowed_pairs(ints[0], ints[1], causal, ints[2], ints[3])
    library_ms = sdpa_ms(q, k, v, ok, out)
    n_bytes = (live_bytes(q, ints[0]) + live_bytes(k, ints[1])
               + live_bytes(v, ints[1]) + nbytes(out, lse, *ints))
    ops = 4 * D * Hq * pairs
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_BF16)
    shape = f"B{B} Sq{Sq} Skv{Skv} Hq{Hq} Hkv{Hkv} D{D}"
    print(f"{name} {shape} {'causal' if causal else 'bidirectional'}: "
          f"max_abs_err {err:.3e}, lse err {lse_err:.3e} (tol {ATOL} + "
          f"{RTOL}|plain|, lse {LSE_TOL}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.3f} GFLOP over "
          f"{pairs} allowed pairs, {n_bytes / 1e6:.1f} MB)")
    # one source for two TPU kernels: the flash forward, and the single-pass
    # row-block kernel behind rowblock_fwd
    return dict(name="rowblock_fwd" if through_rowblock
                else "flash_attention_fwd", route="cuda",
                source="procyon_tpu_torch/csrc/flash_attention_fwd.cu",
                replaces="procyon_tpu/ops/attention_rowblock.py:110"
                if through_rowblock
                else "procyon_tpu/ops/flash_attention.py:354",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def retrieve_prompt_tokens():
    """The live token count of the first smoke request's prompt (the
    collator pads it to 512), from the host code alone."""
    from procyon_tpu_torch.data import collators, datasets
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.inference import prompts
    source, desc = RETRIEVE_DESCRIPTIONS[0]
    batch = prompts.create_input_retrieval(
        f"{source}_all_retrieval", tokenizer=load_tokenizer(vocab_size=128256),
        store=datasets.SyntheticStore(n_proteins=8, embed_dim=8),
        input_description=desc,
        collator_cfg=collators.CollatorConfig(protein_embed_dim=8))
    check(batch["seg_ids"].shape == (1, FLASH_SHAPE["S"]),
          f"prompt rows are {batch['seg_ids'].shape}")
    return int(batch["seg_ids"].sum())


def phase_flash(dev, B):
    """Llama-3-8B prefill: contiguous q / k / v, as the decoder's block
    hands them over from its three projections (the cache case below reads
    strided views). B1 is the /retrieve request (one right-padded prompt);
    larger batches carry a left-padded, a dead and a packed row."""
    import torch
    S, Hq, Hkv, D = (FLASH_SHAPE[k] for k in ("S", "Hq", "Hkv", "D"))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(
        torch.bfloat16) for H in (Hq, Hkv, Hkv))
    seg = torch.ones((B, S), dtype=torch.int64, device=dev)
    if B == 1:
        seg[0, retrieve_prompt_tokens():] = 0
    else:
        seg[1, :150] = 0              # left-padded: first key tiles masked
        seg[2] = 0                    # dead
        seg[3, S // 2 + 7:] = 2       # a second packed segment
    return flash_case("flash", q, k, v, seg, seg, causal=True)


def phase_flash_cache(dev):
    """New tokens over a dense cache: Sq != Skv, positions given, the
    cache's tail empty, k / v slices of a [L, B, Smax, Hkv, D] cache."""
    import torch
    B, Sq, Skv, filled = (FLASH_CACHE[k] for k in ("B", "Sq", "Skv",
                                                   "filled"))
    Hq, Hkv, D = (FLASH_SHAPE[k] for k in ("Hq", "Hkv", "D"))
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=dev).to(
        torch.bfloat16)
    cache = torch.randn((2, 2, B, Skv, Hkv, D), generator=g, device=dev).to(
        torch.bfloat16)
    seg_q = torch.ones((B, Sq), dtype=torch.int32, device=dev)
    seg_kv = torch.zeros((B, Skv), dtype=torch.int32, device=dev)
    seg_kv[:, :filled + Sq] = 1
    q_pos = torch.arange(filled, filled + Sq, device=dev).expand(B, Sq)
    kv_pos = torch.arange(Skv, device=dev).expand(B, Skv).clone()
    kv_pos[:, filled + Sq:] = 0
    return flash_case("flash (cache)", q, cache[0, 1], cache[1, 1], seg_q,
                      seg_kv, causal=True, q_pos=q_pos, kv_pos=kv_pos)


def phase_rowblock_fwd(dev):
    """ESM2-35M's attention (20 heads of 24) at the shape phase_esm35m's
    forward gives it: the packed kernel does not apply, so
    attn_backend="rowblock" takes the single-pass function."""
    import torch
    B, S, H, D = (ESM35M_SHAPE[k] for k in "BSHD")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    seg = torch.ones((B, S), dtype=torch.int32, device=dev)
    seg[0, S - 100:] = 0
    seg[1] = 0
    seg[2, S // 2:] = 2
    return flash_case("rowblock_fwd", q, k, v, seg, seg, causal=False,
                      through_rowblock=True)


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
    cfg = unified.UnifiedConfig(llama=None, esm=ecfg)
    params = serving_params(unified.init_params(SEED + 2, cfg, device=dev),
                            cfg)
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
    cfg = unified.UnifiedConfig(llama=None, esm=ecfg)
    t0 = time.perf_counter()
    params = unified.init_params(SEED, cfg, device=dev)
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


def phase_esm35m(dev):
    """ESM2-35M (12 layers, dim 480, 20 heads of 24) at full depth in bf16
    with attn_backend="rowblock": head_dim 24 is outside the packed
    kernel, so every layer's attention is the single-pass row-block
    function, on the flash kernel's source. B16 x 512 tokens, held against
    the plain path on the CPU in f32 on the same weights."""
    import numpy as np
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.models import esm2, pooling
    from procyon_tpu_torch.ops import attention_rowblock, flash_attention
    B, S = ESM35M_SHAPE["B"], ESM35M_SHAPE["S"]
    cfg = esm2.esm2_config("35m", max_seq_len=S, attn_backend="rowblock",
                           dtype=torch.bfloat16)
    check((cfg.n_heads, cfg.head_dim) == (ESM35M_SHAPE["H"],
                                          ESM35M_SHAPE["D"]),
          f"ESM2-35M heads {cfg.n_heads} x {cfg.head_dim}")
    params = esm2.init_params(SEED + 7, cfg, device=dev)
    rng = np.random.default_rng(SEED + 7)
    tokens = np.full((B, S), esm2.PAD_IDX, np.int64)
    for i, n in enumerate(rng.integers(S // 4, S - 1, B)):
        n = S - 2 if i == 0 else n        # one full row
        tokens[i, 0] = esm2.CLS_IDX
        tokens[i, 1:n + 1] = rng.integers(4, 24, n)
        tokens[i, n + 1] = esm2.EOS_IDX
    tokens = torch.from_numpy(tokens)
    mask = (tokens != esm2.PAD_IDX).to(torch.int32)

    attention_rowblock.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    hidden = esm2.forward(params, cfg, tokens.to(dev))["hidden"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_attention.launches
    check(launches == cfg.n_layers and attention_rowblock.launches == 0,
          f"ESM2-35M: {launches} flash and {attention_rowblock.launches} "
          f"packed launches, expected {cfg.n_layers} and 0")
    check(tuple(hidden.shape) == (B, S, cfg.dim)
          and torch.isfinite(hidden.float()).all().item(),
          "ESM2-35M: bad hidden states")
    t0 = time.perf_counter()
    esm2.forward(params, cfg, tokens.to(dev))
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0

    cfg32 = dataclasses.replace(cfg, attn_backend="ref", dtype=torch.float32)
    p32 = bridge.to_torch(bridge.to_numpy(params), device="cpu")
    t0 = time.perf_counter()
    want = esm2.forward(p32, cfg32, tokens)["hidden"]
    cpu_s = time.perf_counter() - t0
    got = hidden.float().cpu()
    valid = mask.bool()
    tok_cos = torch.nn.functional.cosine_similarity(
        got[valid], want[valid], dim=-1).min().item()
    pooled_cos = cosines(pooling.pool_tokens(got, mask, "mean"),
                         pooling.pool_tokens(want, mask, "mean")).min().item()
    print(f"ESM2-35M ({cfg.n_layers} layers, dim {cfg.dim}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}; bf16, B{B} x {S} tokens, "
          f"{int(mask.sum())} live): {launches} flash-kernel launches, "
          f"forward {dt * 1e3:.1f} ms, again {dt2 * 1e3:.1f} ms (host "
          f"clock, synchronized); card bf16 vs CPU f32 plain path: "
          f"per-token cos_min {tok_cos:.6f}, pooled per-protein cos_min "
          f"{pooled_cos:.6f} (both >= {QUALITY_GATE_COS}) (CPU run "
          f"{cpu_s:.1f} s)")
    check(tok_cos >= QUALITY_GATE_COS, f"ESM2-35M token cos {tok_cos}")
    check(pooled_cos >= QUALITY_GATE_COS,
          f"ESM2-35M pooled cos {pooled_cos}")
    return launches


def phase_fusion_small(dev):
    """The fusion path on the card (bf16, the flash kernel) against the
    plain path on the CPU in f32 (held to procyon_tpu by
    tests/test_torch_fusion.py and test_torch_retrieval_service.py), on the
    same weights and the same prompt: ProCyon-Full widths, the decoder cut
    to 2 layers and, for this check only, the vocabulary cut to 8192."""
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.app.main import procyon_full_config
    from procyon_tpu_torch.data import datasets
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.inference.retrieval_service import \
        startup_retrieval
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import flash_attention as fa
    vocab, n_layers, n_proteins = 8192, 2, 512
    full = procyon_full_config(n_layers)
    cfg = dataclasses.replace(full, llama=dataclasses.replace(
        full.llama, vocab_size=vocab))
    params = unified.init_params(SEED + 6, cfg, device=dev)
    store = datasets.SyntheticStore(n_proteins=n_proteins,
                                    embed_dim=cfg.protein_embed_dim)
    ids = list(range(n_proteins))
    tok = load_tokenizer(vocab_size=vocab)
    svc = startup_retrieval(params, cfg, tok, store, ids, device=dev)
    source, desc = RETRIEVE_DESCRIPTIONS[0]
    task_id = f"{source}_all_retrieval"
    before = fa.launches
    with torch.no_grad():
        batch = svc.query_batch(task_id=task_id, disease_desc=desc)
        q_gpu = unified.retrieval_query_embedding(params, cfg, batch)
    check(fa.launches - before == n_layers,
          "fusion check: the card run did not take the flash kernel")
    top_gpu = svc.retrieve(task_id=task_id, disease_desc=desc, k=10)

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                llama=dataclasses.replace(
                                    cfg.llama, dtype=torch.float32))
    p32 = bridge.to_torch(bridge.to_numpy(params), device="cpu")
    t0 = time.perf_counter()
    svc32 = startup_retrieval(p32, cfg32, tok, store, ids, device="cpu")
    with torch.no_grad():
        q_cpu = unified.retrieval_query_embedding(
            p32, cfg32, svc32.query_batch(task_id=task_id,
                                          disease_desc=desc))
    top_cpu = svc32.retrieve(task_id=task_id, disease_desc=desc, k=10)
    cos = cosines(q_gpu.cpu(), q_cpu).min().item()
    shared = len({r["protein_id"] for r in top_gpu}
                 & {r["protein_id"] for r in top_cpu})
    print(f"fusion check (ProCyon-Full widths, {n_layers} layers, vocab cut "
          f"to {vocab} for this check only, {n_proteins} proteins): card "
          f"bf16 vs CPU f32 plain path query-embedding cosine {cos:.6f}, "
          f"top-10 overlap {shared}/10 (CPU run "
          f"{time.perf_counter() - t0:.1f} s)")
    check(cos >= QUALITY_GATE_COS,
          f"fusion cos {cos} < {QUALITY_GATE_COS}")
    check(shared >= 8, f"fusion top-10 overlap {shared}/10")


def post_json(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def phase_retrieve(dev, profile):
    """The slice's main path: the synthetic ProCyon-Full service on the
    card behind the stdlib HTTP server, five POST /retrieve requests."""
    import numpy as np
    import torch
    from procyon_tpu_torch.app import main as app_main
    from procyon_tpu_torch.app import server
    from procyon_tpu_torch.data.collators import CollatorConfig
    from procyon_tpu_torch.inference import prompts
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import (attention_rowblock, flash_attention,
                                       fused_mlp)
    os.environ["PROCYON_SYNTHETIC"] = "1"
    t0 = time.perf_counter()
    service = app_main._build_service(device=dev)
    torch.cuda.synchronize()
    lcfg = service.cfg.llama
    n_params = sum(t.numel() for t in tree_leaves(service.params))
    print(f"/retrieve: ProCyon-Full ({lcfg.n_layers} layers, dim {lcfg.dim}, "
          f"{lcfg.n_heads}/{lcfg.n_kv_heads} heads, vocab "
          f"{lcfg.vocab_size}), {n_params / 1e9:.2f} B random parameters "
          f"(seed {app_main.SYNTHETIC_SEED}) and "
          f"{len(service.protein_ids)} proteins embedded in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card")
    check(service.all_protein_embeddings.shape
          == (app_main.SYNTHETIC_PROTEINS, service.cfg.retrieval_dim),
          f"table {service.all_protein_embeddings.shape}")

    httpd = server.serve(service, 0, host="127.0.0.1", background=True)
    try:
        port = httpd.server_address[1]
        attention_rowblock.launches = 0
        fused_mlp.launches = 0
        flash_attention.launches = 0
        answers = []
        for source, desc in RETRIEVE_DESCRIPTIONS:
            before = flash_attention.launches
            t0 = time.perf_counter()
            code, body = post_json(port, "/retrieve", {
                "disease_desc": desc, "instruction_source_dataset": source,
                "k": 10})
            dt = time.perf_counter() - t0
            n = flash_attention.launches - before
            check(code == 200, f"/retrieve answered {code}")
            check(n == lcfg.n_layers, f"{n} flash launches in a request, "
                                      f"expected {lcfg.n_layers}")
            recs = body["results"]
            check(len(recs) == 10
                  and [r["rank"] for r in recs] == list(range(1, 11))
                  and all(math.isfinite(r["score"]) for r in recs)
                  and all(a["score"] >= b["score"]
                          for a, b in zip(recs, recs[1:])),
                  f"bad records: {recs}")
            answers.append(recs)
            top3 = [(r["protein_id"], round(r["score"], 4)) for r in recs[:3]]
            print(f"  POST /retrieve ({source}, {len(desc.split())} words): "
                  f"200 in {dt * 1e3:.1f} ms, top-3 {top3}")
        launches = flash_attention.launches
        check(attention_rowblock.launches == 0 and fused_mlp.launches == 0,
              "the frozen-embedding path launched an ESM2 kernel")
        check(post_json(port, "/retrieve", {"disease_desc": "x", "k": 1})[0]
              == 200, "a second round of requests failed")
    finally:
        httpd.shutdown()
        httpd.server_close()
    check(len({tuple(r["protein_id"] for r in a) for a in answers}) > 1,
          "every description ranked the same proteins")
    for (source, desc), recs in zip(RETRIEVE_DESCRIPTIONS, answers):
        direct = service.retrieve(task_id=f"{source}_all_retrieval",
                                  disease_desc=desc, k=10)
        check([r["protein_id"] for r in direct]
              == [r["protein_id"] for r in recs]
              and all(abs(a["score"] - b["score"]) <= 1e-6
                      for a, b in zip(direct, recs)),
              f"HTTP answer differs from service.retrieve for {desc!r}")

    source, desc = RETRIEVE_DESCRIPTIONS[0]
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        service.retrieve(task_id=f"{source}_all_retrieval",
                         disease_desc=desc, k=10)
    torch.cuda.synchronize()
    qps1 = reps / (time.perf_counter() - t0)

    rows = [prompts.create_input_retrieval(
        f"{src}_all_retrieval", tokenizer=service.tokenizer,
        store=service.store, task_library=service.task_library,
        input_description=f"{d} variant {i}",
        collator_cfg=CollatorConfig(
            protein_embed_dim=service.cfg.encoder_out_dim))
        for i, (src, d) in enumerate((RETRIEVE_DESCRIPTIONS * 4)[:16])]
    merged = prompts.merge_model_input_dicts(rows)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in merged.items()}
    check(batch["input_ids"].shape == (16, 512),
          f"batch {tuple(batch['input_ids'].shape)}")
    with torch.no_grad():
        q16 = unified.retrieval_query_embedding(service.params, service.cfg,
                                                batch)
        torch.cuda.synchronize()
        check(tuple(q16.shape) == (16, service.cfg.retrieval_dim)
              and torch.isfinite(q16.float()).all().item(), "bad B16 query")
        t0 = time.perf_counter()
        for _ in range(3):
            unified.retrieval_query_embedding(service.params, service.cfg,
                                              batch)
        torch.cuda.synchronize()
    qps16 = 16 * 3 / (time.perf_counter() - t0)
    live = int(batch["seg_ids"].sum().item())
    print(f"throughput: service.retrieve {qps1:.2f} queries/s (B1, one "
          f"prompt padded to 512 tokens, host clock over {reps} calls); "
          f"retrieval_query_embedding {qps16:.2f} queries/s at B16 x 512 "
          f"tokens ({live} live tokens of 8192)")
    request_breakdown(service, source, desc)
    if profile:
        profile_request(service, source, desc)
    return launches, qps1, qps16


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def request_breakdown(service, source, desc, reps=5):
    """Host-clock split of service.retrieve's three steps, each ended by a
    synchronize: prompt and collator (with the copy to the card), the model,
    and the cosine top-k on the host."""
    import torch
    from procyon_tpu_torch.inference import prompts
    from procyon_tpu_torch.models import unified
    task_id = f"{source}_all_retrieval"
    t = [0.0, 0.0, 0.0]
    with torch.no_grad():
        for _ in range(reps):
            t0 = time.perf_counter()
            batch = service.query_batch(task_id=task_id, disease_desc=desc)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q = unified.retrieval_query_embedding(service.params,
                                                  service.cfg, batch)
            q = q[0].float().cpu().numpy()
            t2 = time.perf_counter()
            prompts.get_proteins_from_embedding(
                service.all_protein_embeddings, q,
                protein_ids=service.protein_ids, top_k=10)
            t3 = time.perf_counter()
            for i, dt in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                t[i] += dt * 1e3 / reps
    print(f"  one request, host clock, mean of {reps}: prompt + collator + "
          f"copy {t[0]:.1f} ms, model (synchronized) {t[1]:.1f} ms, cosine "
          f"top-k over {len(service.protein_ids)} proteins on the host "
          f"{t[2]:.1f} ms")


def profile_request(service, source, desc):
    """One torch.profiler trace of one service.retrieve call (after one
    traced warm-up, which pays the tracer's start): device time by kernel,
    to stdout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            service.retrieve(task_id=f"{source}_all_retrieval",
                             disease_desc=desc, k=10)
            torch.cuda.synchronize()
        return prof, (time.perf_counter() - t0) * 1e3

    traced()
    prof, wall = traced()
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    table = averages.table(sort_by="self_device_time_total", row_limit=25,
                           max_name_column_width=70)
    text = (f"one service.retrieve under torch.profiler: wall {wall:.1f} ms "
            f"(tracing on), device busy {busy:.1f} ms in "
            f"{sum(e.count for e in kernels)} kernels\n{table}")
    print(text)


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
    profile = "--profile" in sys.argv[1:]
    phase_build()
    # the JSON line carries each kernel's results at the shape its main
    # path gives it: ESM2-650M's B64 x L512 batch, the /retrieve request,
    # ESM2-35M's B16 x L512 batch
    kernels = [[phase_attention(dev, b) for b in ATTN_BATCHES][-1],
               [phase_mlp(dev, m) for m in MLP_ROWS][-1],
               [phase_flash(dev, b) for b in FLASH_BATCHES][0]]
    phase_flash_cache(dev)
    kernels.append(phase_rowblock_fwd(dev))
    phase_small_reference(dev)
    launches, cos_min, state = phase_main_path(dev)
    rates, bench_cos = phase_throughput(dev, *state)
    del state
    torch.cuda.empty_cache()
    launches["rowblock_fwd"] = phase_esm35m(dev)
    phase_fusion_small(dev)
    torch.cuda.empty_cache()
    launches["flash_attention_fwd"], qps1, qps16 = phase_retrieve(dev,
                                                                  profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on its "
                                 "main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {
        "model": "esm2-650m W8A8 fused-QKV", "cos_min_retrieval": cos_min,
        "cos_min_pooled_b64": bench_cos,
        "proteins_per_sec_bf16": rates["bf16"],
        "proteins_per_sec_w8a8": rates["w8a8"]}}))
    print(json.dumps({"main_path": {
        "model": "ProCyon-Full /retrieve (Llama-3-8B bf16, 20000 proteins)",
        "flash_launches_5_requests": launches["flash_attention_fwd"],
        "queries_per_sec_b1": qps1, "queries_per_sec_b16": qps16}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
