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
     `retrieval_query_embedding` at B16 x 512 tokens;
  6. holds the caption path's two kernels against their plain versions: the
     page move at the path's shape (a bf16 pool of 32 x 881 pages of
     128 KiB, 2,560 moves with repeating sources; also an int8 pool and an
     f32 scale slab), exact; the paged decode attention at B80 Hq32 Hkv8
     D128 with 12 pages a slot and ragged lengths (a dead slot, a length
     that ends mid-page, one at a page boundary, the full 768), bf16 pools
     and int8 pools with scales, and at B8 for the record, with the port's
     gather route timed beside it at max_ctx 768 and 320;
  7. checks the caption path on the card (bf16, 2 layers at full width, the
     vocabulary cut to 8192 for this check only, 2 prompts of several pages,
     beam 4, 8 new tokens, through a BeamPoolSession), once with the cascade
     and once through the page-walk kernel, against the dense beam search on
     the CPU in f32, on three seeds: stepped under the CPU's beam choices,
     so that every step's log-probabilities and the beam scores can be held
     to a tolerance whatever ties the random weights produce;
  8. drives captioning at ProCyon-Full width on the /retrieve phase's
     parameters, with descriptions of 226 words so that the prompts span
     several pages: 8 proteins through ProcyonCaptionEval(use_paged=True,
     shared_prefix=True) with beam 10, groups of 2, diversity 0.8 and 200
     new tokens (pass A, the default: the cascade, two page moves a step;
     the rows share their full prompt pages and the session caches them),
     then the same batch twice through paged_beam_generate on that session,
     which now prefills only the tails: with the cascade and with
     cascade=False (pass B: every decode layer through the paged attention
     kernel); captions/s, ms per beam step, peak device memory.

Each kernel's least possible time (`bound_ms`) is the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak for their type (989 TFLOP/s bf16, 1979 TOP/s
int8); an attention kernel's operations count the (query, key) pairs this
run's masks allow, and its bytes the q, k and v rows that are not padding;
the paged attention counts the live tokens of this run's lengths, the page
move each moved row read once and written once.
--profile adds one torch.profiler trace of a request and of five beam steps
of each caption route.

Stdout ends with a JSON line of per-kernel results, the card's nvidia-smi
line, and `{"ok": true, "device": {...}}`. Any failed check exits non-zero.
There is no CPU path: without CUDA it exits with status 2.
"""

import contextlib
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
# the caption path (ProCyon-Full, 8 proteins x beam 10): the session's pool
# and one beam step's page moves, one per (layer, slot)
POOL_SHAPE = dict(L=32, n_pages=881, page=64, KD=1024)
PAGE_MOVES = 32 * 80
PAGED_SHAPE = dict(Hq=32, Hkv=8, D=128, page=64, P=12)
PAGED_BATCHES = (8, 80)
CAPTION_PROTEINS = 8
CAPTION_SMALL = dict(layers=2, vocab=8192, prompts=2, beam=4, new_tokens=8)
CAPTION_SMALL_SEEDS = (SEED + 18, SEED + 20, SEED + 21)
# words of the synthetic descriptions on the caption path (a UniProt
# function annotation's length): the prompts then fill several 64-token
# pages, so the shared prefix, the session's cache and the cascade's prefix
# all carry real pages. 226 words stay just under the collator's budget for
# one text (longer ones get a random crop, a different one for each row,
# and then the rows share nothing) and leave a 20-token tail after the
# shared pages, which a prefill wave sends to the flash kernel (16 or fewer
# would take the short-block route)
CAPTION_TEXT_WORDS = 226
CAPTION_MIN_PROMPT_PAGES = 4
# card bf16 against CPU f32 at 2 layers under the CPU's beam choices: every
# step's log-probabilities (absolute) and the beam scores (relative); and
# the two decode routes against each other at full depth (relative)
SMALL_LOGP_ATOL = 0.25
SMALL_SCORE_RTOL = 2e-2
PASS_SCORE_RTOL = 2e-2
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
    names = ("rowblock_attention", "fused_ln_mlp_int8", "flash_attention_fwd",
             "page_move", "paged_attention")
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
    return launches, qps1, qps16, service


def phase_page_move(dev):
    """The page move at the caption path's shape: the session's bf16 pool
    (32 layers x 881 pages of [64, 1024]), one beam step's 2,560 moves with
    sources that repeat (children of one parent) and never are
    destinations; then an int8 pool and an f32 scale slab [.., 64, 8]
    through the same kernel. Exact equality with the plain version."""
    import torch
    from procyon_tpu_torch.ops import page_move as pm
    L, n_pages, page, KD = (POOL_SHAPE[k] for k in ("L", "n_pages", "page",
                                                    "KD"))
    N, M = L * n_pages, PAGE_MOVES
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    perm = torch.randperm(N, generator=g, device=dev)
    dst = perm[:M].to(torch.int32)
    src = perm[M:][torch.randint(0, M // 4, (M,), generator=g,
                                 device=dev)].to(torch.int32)
    check(src.unique().numel() < M, "page move: sources do not repeat")
    result = None
    for dtype, tail in ((torch.bfloat16, (page, KD)), (torch.int8, (page, KD)),
                        (torch.float32, (page, KD // 128))):
        pool = torch.randint(-100, 100, (N, *tail), generator=g,
                             device=dev, dtype=torch.int32).to(dtype)
        want = pm.move_pages_direct_ref(pool.clone(), src, dst)
        before = pm.launches
        got = pm.move_pages_direct(pool, src, dst)
        torch.cuda.synchronize()
        check(pm.launches == before + 1, "page move: no launch")
        check(got is pool and torch.equal(got, want),
              f"page move ({dtype}): differs from the plain version")
        del want
        ms, plain_ms = paired_ms(
            lambda: pm.move_pages_direct(pool, src, dst),
            lambda: pm.move_pages_direct_ref(pool, src, dst))
        srcl, dstl = src.long(), dst.long()
        library_ms = cuda_ms(lambda: pool.index_copy_(
            0, dstl, pool.index_select(0, srcl)))
        row_bytes = pool[0].numel() * pool.element_size()
        # a source that repeats is read once
        n_src = src.unique().numel()
        n_bytes = (n_src + M) * row_bytes + nbytes(src, dst)
        bound_ms, bound_by = bound(n_bytes, 0, PEAK_BF16)
        name = str(dtype).split(".")[1]
        print(f"page move {name} pool [{N}, {tail[0]}, {tail[1]}] "
              f"({N * row_bytes / 2 ** 30:.2f} GiB), {M} moves of "
              f"{row_bytes} bytes, {n_src} distinct sources: "
              f"equal to the plain version; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (with its checks of the plan), index_select"
              f" + index_copy_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by} ({n_bytes / 1e6:.1f} MB)")
        if result is None:
            result = dict(
                name="page_move", route="cuda",
                source="procyon_tpu_torch/csrc/page_move.cu",
                replaces="procyon_tpu/ops/page_move.py:83",
                shape=f"pool [{N}, {page}, {KD}] bf16, {M} moves",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
        del pool, got
        torch.cuda.empty_cache()
    return result


def paged_lens(B, max_ctx, page, rng):
    """Ragged lengths: a dead slot, one that ends mid-page, one at a page
    boundary, the full context, the rest between a quarter and three
    quarters of it."""
    lens = rng.integers(max_ctx // 4, 3 * max_ctx // 4, B)
    lens[:4] = (0, 4 * page + page // 2 + 12, 5 * page, max_ctx)
    return lens


def phase_paged_attention(dev, B, quantized):
    """The paged decode attention at Llama-3-8B widths, 12 pages a slot:
    kernel against plain (out and lse), the dead slot exactly 0, times for
    kernel, plain version, the library call (a gather of the pages, then
    scaled_dot_product_attention under the length mask) and the port's own
    gather route (`_decode_attention_step` over the gathered context) at
    max_ctx 768 and 320."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import paged_attention as pa
    Hq, Hkv, D, page, P = (PAGED_SHAPE[k] for k in ("Hq", "Hkv", "D", "page",
                                                    "P"))
    n_pages = B * P + 7
    g = torch.Generator(device=dev).manual_seed(SEED + 9 + B)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    shape = (n_pages, page, Hkv * D)
    if quantized:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand((n_pages, page, Hkv), generator=g, device=dev)
                  * 0.02 + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    table = torch.randperm(n_pages, generator=g, device=dev)[:B * P].reshape(
        B, P).to(torch.int32)
    lens_np = paged_lens(B, P * page, page, np.random.default_rng(SEED + B))
    lens = torch.from_numpy(lens_np).to(dev, torch.int32)
    kw = dict(n_kv_heads=Hkv, head_dim=D, k_scale_pool=ks, v_scale_pool=vs)
    name = f"paged attention{' int8' if quantized else ''}"

    def kernel(t=table, n=lens):
        return pa.paged_decode_attention_fullpage(q, k, v, t, n, **kw)

    def plain():
        return pa.paged_decode_attention_ref(q, k, v, table, lens, **kw)

    before = pa.launches
    (out, lse), (ref, ref_lse) = kernel(), plain()
    torch.cuda.synchronize()
    check(pa.launches == before + 1, f"{name}: the wrapper did not launch")
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite")
    check(within_tol(out, ref), f"{name}: max_abs_err {err}")
    dead = lens == 0
    check(not out[dead].any().item()
          and bool((lse[dead] == -1e30).all().item()),
          f"{name}: the dead slot is not 0 / -1e30")
    lse_err = (lse[~dead] - ref_lse[~dead]).abs().max().item()
    check(lse_err <= LSE_TOL, f"{name}: lse err {lse_err}")
    ms, plain_ms = paired_ms(kernel, plain)

    def gather_route(n_ctx_pages):
        """(kernel ms, gather-route ms) with the context cut to the first
        n_ctx_pages pages of every slot."""
        tab = table[:, :n_ctx_pages].contiguous()
        ctx = n_ctx_pages * page
        n = lens.clamp_max(ctx)
        tab_l = tab.long()
        valid = torch.arange(ctx, device=dev)[None, :] < n[:, None]
        seg_q = torch.ones((B, 1), dtype=torch.int32, device=dev)
        pos_q = n[:, None]
        ctx_pos = torch.arange(ctx, dtype=torch.int32,
                               device=dev).expand(B, -1)

        def route():
            kc = k[tab_l].reshape(B, ctx, Hkv, D)
            vc = v[tab_l].reshape(B, ctx, Hkv, D)
            scales = {}
            if quantized:
                scales = dict(k_scale=ks[tab_l].reshape(B, ctx, Hkv),
                              v_scale=vs[tab_l].reshape(B, ctx, Hkv))
            return llama._decode_attention_step(
                q[:, None], kc, vc, seg_q, valid.to(torch.int32), pos_q,
                ctx_pos, **scales)

        got = route()[:, 0]
        want = kernel(tab, n)[0]
        live = n > 0
        diff = (got[live].float() - want[live].float()).abs().max().item()
        check(diff <= LIBRARY_ATOL, f"{name}: the gather route is {diff} "
                                    f"from the kernel at {ctx} tokens")
        k_ms, r_ms = paired_ms(lambda: kernel(tab, n), route)
        return k_ms, r_ms

    k768, r768 = gather_route(P)
    k320, r320 = gather_route(5)

    library_ms = None
    if not quantized:
        tab_l = table.long()
        S = P * page
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        mask = mask | dead[:, None, None, None]   # a dead row must not NaN
        qt = q[:, :, None, :]                      # [B, Hq, 1, D]

        def library():
            kc = k[tab_l].reshape(B, S, Hkv, D).transpose(1, 2)
            vc = v[tab_l].reshape(B, S, Hkv, D).transpose(1, 2)
            return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)

        lib = library()[:, :, 0]
        diff = (lib[~dead].float() - out[~dead].float()).abs().max().item()
        check(diff <= LIBRARY_ATOL, f"{name}: gather + sdpa is {diff} from "
                                    "the kernel on live slots")
        library_ms = cuda_ms(library)

    live_tokens = int(lens_np.sum())
    es = k.element_size()
    n_bytes = 2 * live_tokens * Hkv * D * es + nbytes(q, out, lse, table,
                                                      lens)
    if quantized:
        n_bytes += 2 * live_tokens * Hkv * 4
    ops = 4 * D * Hq * live_tokens
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_BF16)
    shape_s = f"B{B} Hq{Hq} Hkv{Hkv} D{D} P{P} page {page}"
    lib_s = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"{name} {shape_s}, lengths {lens_np[:4].tolist()} + "
          f"{B - 4} in [{P * page // 4}, {3 * P * page // 4}) "
          f"({live_tokens} live tokens): max_abs_err {err:.3e}, lse err "
          f"{lse_err:.3e} (tol {ATOL} + {RTOL}|plain|, lse {LSE_TOL}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, gather + sdpa "
          f"{lib_s}, bound {bound_ms:.4f} ms by {bound_by} "
          f"({n_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP); the port's "
          f"gather route {r768:.4f} ms against the kernel's {k768:.4f} at "
          f"max_ctx 768, {r320:.4f} against {k320:.4f} at max_ctx 320")
    return dict(name="paged_attention", route="cuda",
                source="procyon_tpu_torch/csrc/paged_attention.cu",
                replaces="procyon_tpu/ops/paged_attention.py:250",
                shape=shape_s, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                gather_route_ms_ctx768=r768, gather_route_ms_ctx320=r320,
                kernel_ms_ctx320=k320)


class LongTextStore:
    """A store whose descriptions run to `words` words. The synthetic store
    writes 14-word descriptions, which leave the caption prompt under one
    64-token page; UniProt's function annotations, which the caption prompt
    quotes as its in-context example, run to hundreds of words. Everything
    but `text` is the wrapped store's."""

    def __init__(self, base, words):
        self.base, self.words = base, words

    def __getattr__(self, name):
        return getattr(self.base, name)

    def text(self, idx):
        head = self.base.text(idx).split()
        out = list(head)
        for i in range(self.words - len(head)):
            out.append(f"{head[i % len(head)]}{i // len(head)}")
        return " ".join(out)


def caption_batch(tokenizer, store, cfg, n):
    """The caption collator's for_generation batch of proteins 0..n-1
    (numpy, left-padded to the collator's max_text_len of 512)."""
    from procyon_tpu_torch.data import collators, instruct
    task = instruct.TaskLibrary().get("uniprot_all_caption")
    coll = collators.CaptionCollator(
        collators.CollatorConfig(protein_embed_dim=cfg.encoder_out_dim),
        tokenizer, store, task)
    return coll([(a, 0) for a in range(n)],
                instruct.get_prompt(task, num_examples=1),
                for_generation=True)


def best_token_agreement(a, b):
    """Share of positions on which the best hypotheses' tokens agree."""
    return float((a[:, 0] == b[:, 0]).float().mean().item())


@contextlib.contextmanager
def patched(module, name, fn):
    """module.name = fn for the length of the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def tie_margins(select, step, logp, gen):
    """Where the card's own selection (from its log-probabilities `logp`
    and the CPU's scores) departs from the CPU's at this step: for each
    prompt, the CPU-side score gap between the CPU's pick and the card's at
    the first beam slot that differs (later slots see other diversity
    counts). Returns (share of equal picks, [gaps])."""
    ref_logp, ref_scores, done, (tok_c, par_c, sc_c) = step
    tok_o, par_o, _ = select(logp, ref_scores, done, gen)
    same = (tok_o == tok_c) & (par_o == par_c)
    gaps = []
    gsz = gen.beam_group_size
    for b in range(same.shape[0]):
        differs = (~same[b]).nonzero()
        if not len(differs):
            continue
        j = int(differs[0])
        par, tok = int(par_o[b, j]), int(tok_o[b, j])
        if bool(done[b, par]):
            cont = 0.0 if tok == gen.eos_token_id else -1e30
        else:
            cont = float(ref_logp[b, par, tok])
        used = int((tok_c[b, :j // gsz * gsz] == tok).sum())
        theirs = float(ref_scores[b, par]) + cont \
            - gen.diversity_penalty * used
        gaps.append(float(sc_c[b, j]) - theirs)
    return float(same.float().mean()), gaps


def caption_small_seed(dev, seed):
    """One seed of phase_caption_small. Returns the largest log-probability
    error over both routes."""
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.app.main import procyon_full_config
    from procyon_tpu_torch.data import datasets
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.inference import generation, paged_beam
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import page_move, paged_attention
    c = CAPTION_SMALL
    full = procyon_full_config(c["layers"])
    cfg = dataclasses.replace(full, llama=dataclasses.replace(
        full.llama, vocab_size=c["vocab"]))
    params = unified.init_params(seed, cfg, device=dev)
    tok = load_tokenizer(vocab_size=c["vocab"])
    store = LongTextStore(
        datasets.SyntheticStore(n_proteins=16,
                                embed_dim=cfg.protein_embed_dim),
        CAPTION_TEXT_WORDS)
    batch = caption_batch(tok, store, cfg, c["prompts"])
    gen = generation.GenerationConfig(
        max_new_tokens=c["new_tokens"], method="beam", beam_size=c["beam"],
        beam_group_size=2, diversity_penalty=0.8,
        eos_token_id=tok.spec.eos_id, pad_token_id=tok.spec.pad_id)
    lens = batch["seg_ids"].sum(1)
    check(int(lens.min()) // 64 >= CAPTION_MIN_PROMPT_PAGES,
          f"caption prompts of {lens.tolist()} tokens fill fewer than "
          f"{CAPTION_MIN_PROMPT_PAGES} pages")
    partial = int((lens % 64 != 0).any())
    select = generation.diverse_beam_select

    # the CPU's dense run in f32, every step's selection recorded
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                llama=dataclasses.replace(
                                    cfg.llama, dtype=torch.float32))
    p32 = bridge.to_torch(bridge.to_numpy(params), device="cpu")
    steps = []

    def recording(logp, scores, done, gen_):
        out = select(logp, scores, done, gen_)
        steps.append((logp.clone(), scores.clone(), done.clone(), out))
        return out

    t0 = time.perf_counter()
    with patched(generation, "diverse_beam_select", recording):
        want_t, want_s = generation.generate_beam(
            p32, cfg32, paged_beam.to_device(batch, "cpu"), gen)
    cpu_s = time.perf_counter() - t0
    del p32
    steps = [tuple(x.to(dev) for x in st[:3])
             + (tuple(x.to(dev) for x in st[3]),) for st in steps]
    print(f"caption check, seed {seed} (ProCyon-Full widths, {c['layers']} "
          f"layers, vocab cut to {c['vocab']} for this check only, "
          f"{c['prompts']} prompts of {lens.tolist()} tokens, beam "
          f"{c['beam']}, {c['new_tokens']} new tokens), card bf16 paged "
          f"against CPU f32 dense (CPU run {cpu_s:.1f} s):")

    worst = 0.0
    for cascade in (True, False):
        what = "cascade" if cascade else "page-walk kernel"
        errs, shares, gaps = [], [], []
        delta = torch.zeros_like(steps[0][1])

        def replay(logp, scores, done, gen_):
            """The CPU's choice for this step, whatever the card's
            log-probabilities say; the two are compared on the way."""
            nonlocal delta
            step = steps[len(errs)]
            ref_logp, _, ref_done, (tok_c, par_c, sc_c) = step
            check(torch.equal(done, ref_done), f"{what}: done flags differ "
                                               f"at step {len(errs)}")
            logp = logp.float()
            err = (logp - ref_logp).abs()[~done].max().item()
            share, step_gaps = tie_margins(select, step, logp, gen_)
            check(all(g <= 2 * err + 1e-5 for g in step_gaps),
                  f"{what}: the card's own pick at step {len(errs)} is "
                  f"{step_gaps} from the CPU's, log-probabilities within "
                  f"{err}")
            par = par_c.long()
            d = torch.gather(logp - ref_logp, 1,
                             par[..., None].expand(-1, -1, logp.shape[-1])
                             ).gather(2, tok_c.long()[..., None])[..., 0]
            delta = torch.gather(delta, 1, par) + torch.where(
                torch.gather(done, 1, par), 0.0, d)
            errs.append(err)
            shares.append(share)
            gaps.extend(step_gaps)
            return tok_c, par_c, sc_c

        session = paged_beam.BeamPoolSession()
        page_move.launches = paged_attention.launches = 0
        with patched(paged_beam, "diverse_beam_select", replay):
            toks, scores = paged_beam.paged_beam_generate(
                params, cfg, batch, gen, session=session, cascade=cascade)
        torch.cuda.synchronize()
        check(session.pcfg.max_ctx >= 512, f"pool max_ctx "
                                           f"{session.pcfg.max_ctx}")
        check(len(session.cache.meta) > 0, "no prompt block was cached")
        moves = 2 * (c["new_tokens"] + partial)
        walks = 0 if cascade else c["layers"] * c["new_tokens"]
        check(page_move.launches == moves
              and paged_attention.launches == walks,
              f"small caption check ({what}): {page_move.launches} page "
              f"moves and {paged_attention.launches} paged attention "
              f"launches, expected {moves} and {walks}")
        check(torch.equal(toks.cpu(), want_t),
              f"{what}: under the CPU's choices the card's token history "
              "is not the CPU's")
        rel = (delta.abs() / steps[-1][3][2].abs().clamp_min(1e-6)
               ).max().item()
        # the same route left to its own choices, for the record: where a
        # pick sits on a tie it takes the other candidate and departs
        free_t, free_s = paged_beam.paged_beam_generate(
            params, cfg, batch, gen, session=session, cascade=cascade)
        free_rel = ((free_s.float().cpu() - want_s).abs()
                    / want_s.abs().clamp_min(1e-6)).max().item()
        print(f"  {what}, stepped under the CPU's choices: log-probabilities "
              f"within {max(errs):.4f} of the CPU's over {len(errs)} steps "
              f"(asserted <= {SMALL_LOGP_ATOL}), beam scores within "
              f"{rel:.5f} (relative; asserted <= {SMALL_SCORE_RTOL}); its "
              f"own pick is the CPU's on {sum(shares) / len(shares):.3f} of "
              f"the (step, beam) entries, and the {len(gaps)} first "
              f"departures are CPU-side gaps of at most "
              f"{max(gaps, default=0.0):.4f}; left to its own choices: best "
              f"tokens agree on "
              f"{best_token_agreement(free_t.cpu(), want_t):.3f}, beam "
              f"scores within {free_rel:.4f}")
        check(max(errs) <= SMALL_LOGP_ATOL,
              f"{what}: log-probabilities {max(errs)} from the CPU's")
        check(rel <= SMALL_SCORE_RTOL, f"{what}: beam scores {rel} from the "
                                       "CPU's")
        worst = max(worst, max(errs))
    return worst


def phase_caption_small(dev):
    """The caption path on the card in bf16 (2 layers at ProCyon-Full width,
    the vocabulary cut to 8192 for this check only; 2 prompts of several
    pages, beam 4, 8 new tokens; a BeamPoolSession, so the pool's max_ctx is
    at least 512), once with the cascade and once with cascade=False (the
    page-walk kernel), against the port's dense generate_beam on the CPU in
    f32 on the same weights. The kernels take bf16, so the card side cannot
    run in f32, and bf16 flips a selection that sits on a near tie, after
    which a beam departs for good. So the card is stepped under the CPU's
    choices: every step's log-probabilities are held to SMALL_LOGP_ATOL, the
    beam scores they add up to to SMALL_SCORE_RTOL, and the token history
    must then be the CPU's exactly. Where the card's own pick would differ,
    the CPU-side gap between the two candidates is shown to lie within
    twice that step's error: a tie, not a fault of a route. No seed is
    chosen for this: several run, and the free-running agreement is printed
    beside each."""
    import torch
    for seed in CAPTION_SMALL_SEEDS:
        caption_small_seed(dev, seed)
        torch.cuda.empty_cache()


def flash_waves(*widths):
    """How many of these prefill waves reach the flash kernel: a session
    pads a wave to the next power of two, and blocks of 16 tokens or fewer
    take the short-block route."""
    return sum((1 << (w - 1).bit_length()) > 16 for w in widths)


def timed_generate(params, cfg, batch, gen, session, cascade):
    """paged_beam_generate with the prefill and the steps timed apart (host
    clock around synchronized work). Returns (tokens, scores, prefill
    seconds, loop seconds, the page plan's shared tokens per row)."""
    import torch
    from procyon_tpu_torch.inference import paged_beam
    marks = {}

    def after_init(ctx):
        torch.cuda.synchronize()
        marks["t"] = time.perf_counter()
        marks["start"] = ctx["start"]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, scores = paged_beam.paged_beam_generate(
        params, cfg, batch, gen, session=session, cascade=cascade,
        after_init=after_init)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return toks, scores, marks["t"] - t0, t2 - marks["t"], marks["start"]


def profile_beam_steps(params, cfg, batch, gen, session, cascade, warm=10,
                       steps=5):
    """torch.profiler over `steps` beam steps of one route after `warm`
    untraced ones: wall and device-busy time per step, kernels per step and
    the kernels that take most of the device time, to stdout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from procyon_tpu_torch.inference import paged_beam
    state, ctx = paged_beam.paged_beam_init(params, cfg, batch, gen,
                                            session=session, cascade=cascade)

    def run(t0, n):
        nonlocal state
        for t in range(t0, t0 + n):
            state = paged_beam.paged_beam_step(
                params, cfg, gen, ctx["pcfg"], ctx["beam"], ctx["private"],
                ctx["g0"], state, t, cascade_pages=ctx["cascade_pages"],
                max_position=ctx["max_len"] + t)
        torch.cuda.synchronize()

    run(0, warm)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(warm, 1)                    # pays the tracer's start
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(warm + 1, steps)
    wall = (time.perf_counter() - t0) * 1e3 / steps
    session.end_batch(ctx["session_rec"], state[1])
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    count = sum(e.count for e in kernels) / steps
    what = "cascade" if cascade else "page-walk kernel"
    print(f"{steps} beam steps ({what}) under torch.profiler: wall "
          f"{wall:.1f} ms a step (tracing on), device busy {busy:.1f} ms a "
          f"step in {count:.0f} kernels a step")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms a step "
              f"in {e.count / steps:6.0f} launches  {e.key[:90]}")


def phase_caption(dev, service, profile=False):
    """The slice's main path: captioning at ProCyon-Full width on the
    /retrieve phase's parameters, store and tokenizer."""
    import torch
    from procyon_tpu_torch.data import instruct
    from procyon_tpu_torch.evaluate.procyon_models import ProcyonCaptionEval
    from procyon_tpu_torch.ops import (flash_attention, page_move,
                                       paged_attention)
    params, cfg, tok = service.params, service.cfg, service.tokenizer
    store = LongTextStore(service.store, CAPTION_TEXT_WORDS)
    lcfg = cfg.llama
    n = CAPTION_PROTEINS
    model = ProcyonCaptionEval(
        params, cfg, tok, store,
        instruct.TaskLibrary().get("uniprot_all_caption"), batch_size=n,
        use_paged=True, shared_prefix=True, device=dev)
    gen = model.gen
    steps = gen.max_new_tokens
    check((gen.beam_size, gen.beam_group_size, gen.diversity_penalty, steps,
           gen.eos_token_id) == (10, 2, 0.8, 200, tok.spec.eos_id),
          f"the caption recipe changed: {gen}")
    batch = caption_batch(tok, store, cfg, n)
    lens = batch["seg_ids"].sum(1)
    partial = int((lens % 64 != 0).any())
    full_pages = (lens // 64).astype(int)
    check(int(full_pages.min()) >= CAPTION_MIN_PROMPT_PAGES,
          f"caption prompts of {lens.tolist()} tokens fill fewer than "
          f"{CAPTION_MIN_PROMPT_PAGES} pages")

    torch.cuda.reset_peak_memory_stats()
    # pass A: the entry point a user calls, the default route (cascade)
    page_move.launches = paged_attention.launches = 0
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captions = model.get_predictions(list(range(n)))
    torch.cuda.synchronize()
    dt_a = time.perf_counter() - t0
    moves_a, walks_a = page_move.launches, paged_attention.launches
    flash_a = flash_attention.launches
    session = model.session
    pcfg = session.pcfg
    pool_bytes = nbytes(session.pool["k"], session.pool["v"])
    cached = len(session.cache.meta)
    print(f"caption path: ProCyon-Full ({lcfg.n_layers} layers), {n} "
          f"proteins x beam {gen.beam_size} (groups of "
          f"{gen.beam_group_size}, diversity {gen.diversity_penalty}), "
          f"{steps} new tokens; prompts of {lens.tolist()} tokens "
          f"({CAPTION_TEXT_WORDS}-word descriptions); pool "
          f"{pcfg.n_pages} pages x {pcfg.n_layers} layers, max_ctx "
          f"{pcfg.max_ctx}, {pool_bytes / 1e9:.2f} GB")
    check(sorted(captions) == list(range(n))
          and all(isinstance(c, str) and c for c in captions.values()),
          f"bad captions: {captions}")
    check(len(set(captions.values())) > 1, "every protein got one caption")
    check(moves_a == 2 * (steps + partial) and walks_a == 0,
          f"pass A: {moves_a} page moves and {walks_a} paged attention "
          f"launches, expected {2 * (steps + partial)} (k and v per step"
          f"{', and the partial prompt page' if partial else ''}) and 0")
    check(pcfg.max_ctx == 768 and pcfg.n_pages == POOL_SHAPE["n_pages"],
          f"the session's pool changed: {pcfg}")
    # the rows share every full prompt block (one instruction and one
    # in-context example): row 0 prefills them in a first wave, the others
    # only their tails in a second, and the session keeps the blocks
    shared = int(full_pages[0]) * 64
    tail = int(lens.max()) - shared
    flash_a_want = lcfg.n_layers * flash_waves(int(lens[0]), tail)
    check(cached == int(full_pages[0]) and flash_a == flash_a_want,
          f"pass A: {cached} prompt blocks cached and {flash_a} flash "
          f"launches, expected {int(full_pages[0])} blocks and "
          f"{flash_a_want} launches (a wave of {int(lens[0])} tokens, then "
          f"one of {tail})")
    print(f"  pass A, ProcyonCaptionEval.get_predictions (cascade): "
          f"{dt_a:.2f} s, {n / dt_a:.3f} captions/s; {moves_a} page moves "
          f"(2 x {steps} steps + {2 * partial} for the partial prompt "
          f"pages), 0 paged attention launches, {flash_a} flash launches "
          f"in the prefill waves (row 0's whole prompt, then the other "
          f"rows' {tail}-token tails over its {cached} shared pages, which "
          f"the session keeps)")
    print(f"  caption of protein 0: {captions[0][:100]!r}")

    # the same batch again through paged_beam_generate on that session: the
    # cascade, then the page-walk kernel (pass B). The session's cache now
    # holds the prompts' full blocks, so each prefills only the rows' tails.
    runs = {}
    for cascade in (True, False):
        page_move.launches = paged_attention.launches = 0
        flash_attention.launches = 0
        toks, sc, init_s, loop_s, start = timed_generate(
            params, cfg, batch, gen, session, cascade)
        walks = 0 if cascade else lcfg.n_layers * steps
        what = "cascade rerun" if cascade else "pass B"
        check(paged_attention.launches == walks
              and page_move.launches == 2 * (steps + partial),
              f"{what}: {paged_attention.launches} paged attention launches "
              f"and {page_move.launches} page moves, expected {walks} and "
              f"{2 * (steps + partial)}")
        check((start == full_pages * 64).all()
              and flash_attention.launches
              == lcfg.n_layers * flash_waves(tail),
              f"{what}: the cached prompt blocks were prefilled again "
              f"(shared tokens {start.tolist()}, "
              f"{flash_attention.launches} flash launches)")
        runs[cascade] = (toks, sc, init_s, loop_s)
    tok_a, sc_a, init_a, loop_a = runs[True]
    tok_b, sc_b, init_b, loop_b = runs[False]
    walks_b = lcfg.n_layers * steps
    for name, sc in (("A", sc_a), ("B", sc_b)):
        check(torch.isfinite(sc).all().item(), f"pass {name}: bad scores")
    rel = ((sc_a - sc_b).abs() / sc_a.abs().clamp_min(1e-6)).max().item()
    agree = best_token_agreement(tok_a, tok_b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  both reruns prefill only the tails: {shared} "
          f"of each row's tokens come from the session's cache")
    print(f"  cascade, prefill + steps: prefill {init_a * 1e3:.1f} ms, "
          f"{loop_a / steps * 1e3:.2f} ms per beam step, "
          f"{n / (init_a + loop_a):.3f} captions/s")
    print(f"  pass B, page-walk kernel (cascade=False): prefill "
          f"{init_b * 1e3:.1f} ms, {loop_b / steps * 1e3:.2f} ms per beam "
          f"step, {n / (init_b + loop_b):.3f} captions/s; {walks_b} paged "
          f"attention launches ({lcfg.n_layers} x {steps})")
    print(f"  pass A against pass B: beam scores within {rel:.4f} "
          f"(relative; asserted <= {PASS_SCORE_RTOL}); best hypotheses' "
          f"tokens agree on {agree:.3f} of the positions; best scores "
          f"{[round(x, 2) for x in sc_a[:, 0].tolist()]}; peak device "
          f"memory {peak:.2f} GiB")
    check(rel <= PASS_SCORE_RTOL, f"pass A and B beam scores differ by {rel}")
    if profile:
        for cascade in (True, False):
            profile_beam_steps(params, cfg, batch, gen, session, cascade)
    return dict(page_move=moves_a, paged_attention=walks_b), dict(
        captions_per_sec_eval=n / dt_a,
        ms_per_step_cascade=loop_a / steps * 1e3,
        ms_per_step_paged_kernel=loop_b / steps * 1e3,
        captions_per_sec_cascade=n / (init_a + loop_a),
        captions_per_sec_paged_kernel=n / (init_b + loop_b),
        score_rel_diff=rel, best_token_agreement=agree,
        peak_device_gib=peak, pool_gb=pool_bytes / 1e9,
        prompt_tokens=lens.tolist())


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
    # ESM2-35M's B16 x L512 batch, one beam step of the caption path
    kernels = [[phase_attention(dev, b) for b in ATTN_BATCHES][-1],
               [phase_mlp(dev, m) for m in MLP_ROWS][-1],
               [phase_flash(dev, b) for b in FLASH_BATCHES][0]]
    phase_flash_cache(dev)
    kernels.append(phase_rowblock_fwd(dev))
    kernels.append(phase_page_move(dev))
    for quantized in (False, True):
        paged = [phase_paged_attention(dev, b, quantized)
                 for b in PAGED_BATCHES][-1]
        if not quantized:
            kernels.append(paged)
    phase_small_reference(dev)
    launches, cos_min, state = phase_main_path(dev)
    rates, bench_cos = phase_throughput(dev, *state)
    del state
    torch.cuda.empty_cache()
    launches["rowblock_fwd"] = phase_esm35m(dev)
    phase_fusion_small(dev)
    torch.cuda.empty_cache()
    phase_caption_small(dev)
    torch.cuda.empty_cache()
    launches["flash_attention_fwd"], qps1, qps16, service = phase_retrieve(
        dev, profile)
    caption_launches, caption = phase_caption(dev, service, profile)
    launches.update(caption_launches)
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
    print(json.dumps({"main_path": {
        "model": "ProCyon-Full captioning (8 proteins x beam 10, 200 new "
                 "tokens, paged pool, shared prefix)",
        "page_move_launches": launches["page_move"],
        "paged_attention_launches": launches["paged_attention"],
        **caption}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
