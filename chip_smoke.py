#!/usr/bin/env python3
"""Smoke run of procyon_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--profile]
        [--only=flash,flash_bwd,flash_fit,w8a8,mlp,int4,paged,times,
                swiglu,gelu,decode,serving,eval,bert,esm_train,dist,
                benches]

Builds the port's CUDA kernels from procyon_tpu_torch/csrc (one nvcc per
source, all started together), then:
  1. prints the card (nvidia-smi name, power limit) and the build time;
  2. holds each kernel against its plain PyTorch version on the card in
     bf16 and times kernel, plain version and, where there is one, the one
     PyTorch call that computes the same function (CUDA events): the
     row-block attention and the fused LN + int8 MLP at ESM2-650M widths
     (the row-block attention also at ESM2-3B's 40 heads; both launched
     twice for the same bits; the MLP's hidden codes against the plain
     stage, its three kernels' device time, and the port's unfused W8A8
     route for the same layer timed beside it);
     the flash forward at Llama-3-8B widths (Hq 32, Hkv 8, D 128, causal)
     for the /retrieve request's B1 x 512, for B4 and B16 with a
     left-padded, a dead and a packed row, at the training shape B2 x
     S2048 (nothing padded; sdpa with is_causal and no mask beside it), at
     a cache shape (64 new tokens over 1024 slots, positions given), and
     through rowblock_fwd at ESM2-35M's shape (H 20, D 24, with
     log-sum-exp), each launched twice for the same bits;
  3. drives the protein-embedding path at full ESM2-650M width (33 layers,
     W8A8, fused QKV, seeded random weights), as before: kernel launches
     per layer, the W8A8-vs-bf16 cosine, a small-input check against the
     plain path on the CPU in f32, cosine top-k queries, proteins/s
     through scripts/bench_w8a8.py's `run` (bf16 and W8A8 on one B64 x
     L512 batch, rows 1 and 4 counted a call, its JSON line); then ESM2-35M (head_dim 24, outside the packed row-block kernel) at
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
     and int8 pools with scales, and at B16 (serving's batch) and B8, each
     against the plain version and its chunked cut, twice for the same
     bits, timed on cold pools, with the port's gather route timed beside
     it at max_ctx 768 and 320; and B16 with lengths 0, 1, one page and
     the whole table in turn (whole chunks of the page walk dead);
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
     kernel); captions/s, ms per beam step, peak device memory;
  9. holds the int4 unpack + matmul kernel against its plain version at the
     five weight shapes of Llama-3-8B (wq / wo, wk / wv, w_gate / w_up,
     w_down, lm_head; groups of 128) at 16 rows, and at 128 and 256 rows on
     the w_gate shape, twice for the same bits and one device kernel a
     call (torch.profiler), cycling over copies of the weight that
     together exceed the L2 cache, as a forward finds them cold; beside it
     `dequantize4` + `torch.matmul` (the library call) and the bf16
     `x @ w` of the same shape; the wrapper's host time a call, and the
     per-layer launches' time by the blocks an SM the plan aims at;
 10. checks continuous-batching serving on the card (bf16, int4 weights
     through the kernel, 2 layers, vocabulary 8192): a ContinuousBatcher
     with chunk-free prefill, a prefix cache and 4-step rounds against the
     same batcher on the CPU in f32 on the same weights, stepped under the
     CPU's tokens so that every sampled row's logits can be held to a
     tolerance whatever ties the random weights make; and the int4 logits
     by the kernel route against the dequantize route;
 11. drives serving at Llama-3-8B width on the /retrieve phase's decoder:
     16 slots, 48 requests alternating token and fused prompts behind one
     shared 256-token instruction prefix (prefix cache on), private tails
     of 64-256 tokens, 64 new tokens, 8-step rounds, arrivals over the
     first 12 rounds, a 1 GiB pool of 64-token pages (max_ctx 640, so every
     decode step walks the pages in the paged attention kernel); once with
     bf16 weights, once with int4 weights (every matmul of at most 256 rows
     through the int4 kernel), once more in bf16 with async_rounds, then
     int4 and bf16 again (the host's speed drifts, and it bounds a round);
     requests/s, output tokens/s, latency, slot utilisation, ms per round,
     waste, peak memory; each run through scripts/bench_serving.py (its
     workload, pool, batcher, drive loop and `run`, whose JSON line it
     prints);
 12. speculative decoding on the induced-bigram int8 checkpoint
     (models/synthetic.py, period 16) at full width and depth: spec_k=7
     with spec_quantum 1 and 4 against plain greedy rounds on the same
     requests, tokens equal, acceptance per round;
 13. POST /generate from four concurrent HTTP clients against a
     GenerationService over the bf16 batcher: each answer equals the
     tokens the same prompt gets alone;
 14. holds the flash backward kernels (dq; dk and dv) against their plain
     version at Llama-3-8B widths (Hq 32, Hkv 8, D 128, causal): the
     training shape B2 x S2048, B4 x 512 with a right-padded, a dead and a
     packed row, and B2 x 512 with positions given (each pair launched twice
     for the same bits); each kernel's device
     time from torch.profiler, the pair's from CUDA events (the dq kernel
     computes delta, so nothing runs between the two), the backward of
     scaled_dot_product_attention beside them;
 15. checks one QLoRA QA train step on the card (bf16, ProCyon-Full widths
     cut to 2 layers, vocabulary 8192 for this check only, int8 frozen
     base, LoRA r16 x 4 with nonzero B) against the same step on the CPU in
     f32 from the same weights: the loss, the cosine of every trainable
     leaf's gradient and of its update, the parameters after the update;
 16. trains at Llama-3-8B width on the /retrieve phase's decoder quantized
     to int8, with LoRA banks r16 x 4, the projectors and the contrastive
     temperature trained (scripts/bench_train.py --flagship's recipe: B2 x
     S2048, labels over the second half, one soft token, remat; its
     `qlora_config`, `qlora_params`, `train_batch` and `run`): QA steps
     warmed, then timed by bench_train's two points (2 and 6 steps), then
     the combined QA + retrieval step on expert 3, warmed and timed alike; ms per step, tokens/s, MFU, peak
     memory, first and last loss, launches of the flash kernels a step
     (64 forward, 32 dq, 32 dkv a pass), frozen leaves unchanged and every
     trainable leaf changed;
 17. runs `python -m procyon_tpu_torch.scripts.run_pretrain --synthetic true
     --max_steps 20` in its own process on the card and restores the
     checkpoint it wrote;
 18. holds the staged page move (one launch: its plan on the device, the
     rows that are a source and a destination copied aside, then the
     moves grouped by source) against its plain version, exactly, twice
     for the same bits, at the caption pool's shape with 2,560 moves whose
     sources overlap their destinations (a swap, a 3-cycle, a chain, 64
     destinations permuted, repeated sources), for bf16, int8 and f32
     slabs; the same plan through the direct move must differ;
     index_select + index_copy_ beside it; the direct and staged moves'
     rates as shares of the card's copy rate (a 1 GiB Tensor.copy_);
 19. holds the LN + row quantization (codes, scales, twice for the same
     bits, its share of the copy rate) and the two-pass int8
     MLP (with and without the residual, twice for the same bits, its
     hidden codes against the plain stage, the W8A8 route beside it)
     against their plain versions at ESM2-3B's MLP on a B64 x L512 batch,
     and the fused int8 decode MLP at
     Llama-3-8B width at 8 and 16 rows (each of its two kernels' device
     time from torch.profiler);
 20. drives the two probe entry points at full width:
     `probe_fused_decode` (Llama-3-8B MLP, 32 distinct int8 layers, 16 and
     8 rows: us a layer for the port's int8 route, the kernel and bf16
     `x @ w`, beside the weight-streaming floor) and
     `probe_fused_mlp_blocks` (ESM2-3B: the one-pass kernel against the
     two passes);
 21. holds the RMSNorm + W8A8 SwiGLU MLP kernel (row 7) against its plain
     version at the Bind prefill's MLP (4096 rows, d 4096, I 11008) and at
     I 14336, per element in hidden-code steps, with a group's scale
     doubled and the last row tile left out shown to fail that check;
     kernel, plain version and the port's W8A8 route (rms_norm,
     qmatmul_w8a8 gate / up, SiLU * u, qmatmul_w8a8 down) timed on the
     same tensors, and the MLP's cosine to the route;
 22. checks the W8A8 prefill path on a 2-layer copy of the bench decoder
     (full width) on the card in bf16 against the CPU in f32: Bind
     yes-probabilities, retrieval query embeddings and their top-10;
 23. drives the three W8A8 entry points at the reference's defaults on
     one decoder built from a seed (dim 4096, 30 layers, I 11008, vocab
     32000, int8): bench_prefill (weight-only and W8A8 tokens/s at B4 x
     S2048), bench_bind (pairs/s, W8A8 and weight-only) and
     bench_retrieval (queries/s, 57,000 targets), each through its `run`;
     the W8A8 quality gates against bf16 on the same weights: the Bind
     answer's CE delta over the vocabulary (bind_ce_delta, at the
     reference's W8A8 bound) and the retrieval embedding cosine, each also
     read with the flash forward's plain version in place of the kernel (P
     rounded as the kernel rounds it, and unrounded), the yes-probability
     gap reported only, one layer's activation scale doubled shown to fail
     a gated check, and quant_quality.probe (int8 W8A8, int8 and int4
     weight-only); then
     runs row 7 on every layer of the Bind prefill on that layer's own MLP
     input beside the route (whose output goes on): per-layer ms and
     cosine, 30 launches;
 24. ProcyonQAEval + run_qa_eval on the 2-layer copy in W8A8, card against
     CPU, and a save_model -> load_model round trip on the card;
 25. the evaluation slice, each part beside the phase it shares a model
     with: after 4, ProcyonRetrievalEval at ProCyon-Full widths cut to 2
     layers (vocabulary 8192 for this check only), card bf16 against CPU
     f32, the cosine matrices of 4 queries x 512 proteins within
     RETRIEVAL_SMALL_ATOL; after 5, on the /retrieve service,
     ProcyonRetrievalEval + run_retrieval_eval with the full
     RetrievalEvalConfig (top-k 10 / 20 / 100, class-balanced resampling,
     bootstrap): 64 disgenet queries in batches of 16 against all 20,000
     proteins, relations and train leaks from a seed, the eval's target
     table against the service's, its first score rows against a direct
     query embedding, every metric finite and in range, row 3 once a layer
     a batch; queries/s, the target sweep's and the host metrics'
     seconds; in 8, calc_caption_metrics over pass A's captions; in 16,
     one build_midtrain_eval call on the QLoRA state (2 val batches a task,
     4,096 targets); after 17, `run_eval_framework --synthetic --device
     cuda` (ProCyon and the baselines, retrieval, QA and caption) in its
     own process, its baselines' rows equal to a `--device cpu` run's;
 26. the BERT slice (slice 6b), after 25: row 3 at BERT's shape (B128
     S512 H12 D64, bidirectional, right-padded to BERTScore's lengths)
     against its plain version beside sdpa with the same key mask (a
     further shape of the flash_attention_fwd entry); BERTScore at
     SciBERT-base width (vocab 31090, 12 layers, layer 8; weights drawn as
     an HF state dict and loaded through convert_hf_state; a synthetic
     WordPiece vocabulary): its 2-layer copy on the card against the CPU
     in f32, the references reversed shown to fail that check, then 512
     candidates x 3 references (texts of 30-400 tokens) in chunks of 64
     pairs, idf off and on, and a baseline from compute_baseline over
     1,000 pairs applied: pairs/s, the encoder's share, row 3 once a layer
     an encoder call; the five text baselines through run_evaluation over
     a store of 2,000 proteins (64 retrieval queries, 64 QA pairs), each
     with its towers at full width preloaded and deleted before the next
     (PubMedBERT-base for pubmedbert and simcse; the BioTranslator CNN at
     CNNConfig's defaults with a PubMedBERT text tower; ProtST's ESM2-650M
     and PubMedBERT with tower_mlp heads to 512; ProtLLM's ESM2-650M,
     projector and Llama-2-7B-width decoder): every metric finite,
     queries/s or pairs/s, peak memory; then `run_eval_framework
     --use_bertscore` and `compute_bertscore_baseline --synthetic` on the
     card;
 27. the live-encoder slice (slice 1 remainder), after 16 on the same
     service: a FASTA of 20,000 synthetic proteins (50-1024 residues, a
     quarter longer) read by ProCyonDataStore through the native FASTA
     index, built with g++ from the checkout (index seconds, sequences
     read a second; the library must build); rows 3, 8 and 9 at ESM2-3B's
     training attention (B8 S1026 H40 D64, bidirectional, right-padded to
     the MLM batch's lengths) and with a 16-key prefix (Skv 1042), each
     against its plain version beside sdpa with the key mask; one MLM
     loss and the gradients of the banks, a prefix and an adapter at
     ESM2-3B width cut to 2 layers, card bf16 against CPU f32, with the
     expert index off by one and the prefix keys rotated by position
     shown to fail that check; then LoRA phase training with ESM2-3B in
     bf16 (MoLoRA r8 x 4 on its six projections) beside 16's int8 QLoRA
     decoder through Trainer(lora_phase_training=True) and run_pretrain's
     freeze mask: qa on expert 0 (B2 x S2048, 8 proteins encoded live),
     retrieval on 1, mlm on 2 (8 proteins x 1024 residues from the
     store), the joint step on 3; 2 warm and 4 timed global steps, ms a
     phase, the MLM step's tokens/s and MFU, peak memory, launches of
     rows 3, 8 and 9 and of the GELU pair a phase (two forwards a layer
     under remat); then the
     trained encoder merged, quantized and fused, one W8A8 batch of B16 x
     S1024 (rows 1 and 4) against the merged bf16 encoder;
 28. more than one rank (path n), after the W8A8 group: row 10 at a TP 2
     rank's B16 Hq16 Hkv4; two ranks of this script (--dist-worker) on
     the card over gloo (NCCL refuses two ranks on one device): TP 2
     serving at Llama-3-8B width (32 layers; each rank half the weights
     and 4 of 8 kv heads; 16 requests behind a 256-token prefix, 32 new
     tokens, in plain, int8 KV, spec_k 2 and prefix cache + wave prefill)
     replaying the one-process run's choices with every sampled row's
     logits held, the two ranks' own tokens equal, a skipped all-reduce
     after wo shown to fail; data parallelism and FSDP on the QLoRA step
     (8 layers, B1 a rank; meshes (2, 1, 1) and (1, 2, 1), the combined
     step's global contrastive batch) with loss, grad_norm and every
     gradient held to the one-process step, a mean of the ranks' means
     and positives at the local index shown to fail; run_pretrain on one
     NCCL rank under torchrun against the plain run, bit for bit; and
     scripts/dryrun_multichip.py on two ranks. Launches of rows 3, 8, 9
     and 10 a rank are printed and added to the kernels line. Two gloo
     ranks on one card check correctness and give no speed number;
 29. the bench scripts and the slice's other entry points: after 25's
     retrieval eval, scripts/protein_retrieval_disease_pheno.py's `run` on
     the /retrieve service (the service's own top 10, row 3 once a layer a
     query); after 27, each model freed before the next is built:
     scripts/bench_decode.py --paged at dim 4096 x 32 layers (B16 x L512;
     bf16 seeded, then int4 with its quality gate; rows 3, 10 and, in
     int4, 13 counted), scripts/bench_caption.py at Llama-3-8B in int4
     (paged, B4 x beam 10, L448, the cascade and the flat page walk in one
     run; rows 3, 10, 12 and 13 counted, the quality gate), entry()'s
     fn against the CPU in f32, and utils/trace.device_op_table on a
     utils/profiling.trace of row 3 at the training shape (its launches,
     and its time a launch within 25% of the CUDA events', from one
     trace); each prints its JSON line and peak memory. Each of these
     paths and cell e's runs records every shape at which it launches rows
     3, 10, 12 and 13 (LaunchShapes), and each kernel is then held against
     its plain version at each of those shapes on seeded random values
     (the path's own segments, positions, page tables and move lists).
 30. the bias add + erf-GELU pair of ESM2's unfused MLP (csrc/gelu_erf.cu;
     after row 7, its numbers in the kernels line): at ESM2-3B's index
     call (GELU_SHAPE, bf16 with bias) the forward against the plain chain
     and the backward, through GeluErf, against torch.autograd of the plain
     chain, one launch each, times beside the plain chain's and F.gelu's
     and the bound; the launches in the kernels line are 27's, the LoRA
     phase training with ESM2-3B.

Each kernel's least possible time (`bound_ms`) is the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak for their type (989 TFLOP/s bf16, 1979 TOP/s
int8); an attention kernel's operations count the (query, key) pairs this
run's masks allow, and its bytes the q, k and v rows that are not padding;
row 7 counts 6 M d H int8 operations against its int8 weights, scales, x,
the norm weight and out;
the paged attention counts the live tokens of this run's lengths, the page
moves each moved row read once (a source that repeats once) and written
once, the int4 matmul its packed weights, scales, x and out, the row
quantization x, its affine, the codes and the scales, the fused decode MLP
its int8 weights, scales, x, the norm weight and out.
The flash backward's operations are five products over the allowed pairs
(the dq kernel's least work three, the dk / dv kernel's four); the dq
kernel's bytes also count the live out rows it reads for delta and the
delta it writes.
--profile adds one torch.profiler trace of a W8A8 ESM2-650M batch, of a
request, of five beam steps
of each caption route, of one 8-step decode round of the serving path
with bf16 and with int4 weights, of one QA train step, of one W8A8
Bind batch, of one BERTScore encoder call and of one MLM train step of
ESM2-3B.

The build prints ptxas' registers and spills for each kernel function, and
any note that it serialized a kernel's wgmma products.
Stdout ends with a line that names the earlier versions of kernel rows 1,
2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13 and 14 with their times as PERF.md
section 6 records them (not
measured here), a JSON line of per-kernel results, the main paths' lines
(the ESM2, retrieval eval and training lines with the card's nvidia-smi
line), the card's
nvidia-smi line, and `{"ok": true, "device": {...}}`. Any failed check
exits non-zero.
There is no CPU path: without CUDA it exits with status 2.
--only=GROUP[,GROUP] builds the kernels and runs only those groups of
phases ("flash": the flash forward's cases; "flash_bwd"; "flash_fit": the
forward's time split into a cost an item and a cost a tile pair; "w8a8":
the W8A8 prefill path and its quality gates; "mlp": the int8 MLP kernels,
rows 4-6, then the ESM2-650M main path and its throughput; "int4": the
int4 matmul's shapes; "paged": the paged decode attention's batches;
"times": rows 5, 11, 12, 13, 10, 7 and 14 timed alone by the wrappers'
calls, with the card's copy rate, for pairing with an earlier commit;
"swiglu": row 7's checks and times; "decode": row 14's checks and its
probe; "serving"; "eval": the evaluation slice's phases of item 25, with
the caption path of item 8 for its metrics and the mid-train eval on the
service's bf16 decoder; "bert": item 26; "esm_train": item 27 on the
synthetic service; "dist": item 28; "benches": item 29, with
bench_w8a8 (item 3's ESM2-650M path), bench_serving (item 11) and
bench_train (item 16) on the synthetic service first), and prints no
result line.
"""

import contextlib
import dataclasses
import functools
import itertools
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
ATTN_3B_HEADS = 40          # ESM2-3B (ProCyon-Full's encoder): H40 D64
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
# the kernels a call of the int8 MLP launches (the one-pass form; the
# two-pass form launches the last two after its own row pass)
MLP_KERNELS = ("ln_quant_rows_kernel", "mlp_up_kernel", "mlp_down_kernel")
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
# the two-pass int8 MLP (rows 5 and 6) at ESM2-3B, ProCyon-Full's protein
# encoder, on a B64 x L512 batch; the row pass's codes may differ from the
# plain version's at rounding ties only (f32 sums in another order)
ESM3B_MLP = dict(M=64 * 512, d=2560, H=10240)
CODE_FLIPS = 1e-3
SX_RTOL = 1e-6
# the fused decode MLP (row 14) at Llama-3-8B: one bf16 output rounding on
# both sides; a (bf16 after sums in another order) may take the
# neighbouring value, which moves the output by far less than DECODE_ATOL
DECODE_SHAPE = dict(d=4096, I=14336, layers=32)
DECODE_ROWS = (8, 16)
DECODE_COLD = 4                    # distinct layers in turn: 704 MB
DECODE_ATOL = 2e-3
# probe_fused_decode: after 32 layers the kernel's chain against the int8
# route's (bf16 scales, bf16 products), a share of the largest output
PROBE_CHAIN_RTOL = 5e-2
PAGED_BATCHES = (8, 16, 80)        # the caption check, serving, captioning
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
# the int4 matmul at Llama-3-8B: (name, k, n, launches of it in a forward)
INT4_GROUP = 128
INT4_SHAPES = (("wq/wo", 4096, 4096, 64), ("wk/wv", 4096, 1024, 64),
               ("w_gate/w_up", 4096, 14336, 64), ("w_down", 14336, 4096, 32),
               ("lm_head", 4096, 128256, 1))
INT4_ROWS = 16                      # a decode round's 16 slots
INT4_MORE_ROWS = (128, 256)         # on the w_gate shape
L2_BYTES = 50e6
# against x @ dequantize4(qw) in bf16, which rounds q * s to bf16 before
# the product (2^-9 relative a weight): a share of the largest output
INT4_DEQUANT_RTOL = 4 * 2.0 ** -8
# the serving check: card bf16 (int4 kernel route) against CPU f32 on the
# same int4 weights, every sampled row's logits under the CPU's tokens
SERVING_SMALL = dict(layers=2, dim=1024, heads=8, kv_heads=2,
                     intermediate=2816, vocab=8192, slots=4, new_tokens=12,
                     quantum=4)
SERVING_LOGIT_ATOL = 0.25
# scripts/bench_serving.py's default traffic with its protein-serving
# options (shared instruction prefix, prefix cache)
SERVING = dict(slots=16, requests=48, min_prompt=64, max_prompt=256,
               shared_prefix=256, max_new=64, step_quantum=8,
               arrival_rounds=12, page_size=64, pool_mb=1024)
SPEC = dict(period=16, spec_k=7, requests=16, max_new=64, prompt=(8, 40))
QUALITY_GATE_COS = 0.999   # bench.py's gate, printed beside cos_min
SANITY_COS = 0.99          # random weights: asserted bound
# the flash backward (rows 8 and 9) at Llama-3-8B widths: the training
# shape, and a B4 batch with padded, dead and packed rows. Kernel against
# plain, both bf16 out of f32 sums that run in another order (and ds may
# round to the neighbouring bf16 value): each element within GRAD_ROW_TOL
# of the largest gradient in its own row (a query's dq, a key's dk or dv:
# under causal attention late rows' and keys' gradients are far smaller
# than the first ones'), GRAD_FLOOR of the tensor's largest (f32 noise
# where ds cancels, as in a row that sees one key) and one bf16 ulp of
# itself; and ||kernel - plain|| / ||plain|| within GRAD_FRO_TOL
FLASH_BWD_TRAIN = dict(B=2, S=2048)
FLASH_BWD_MASKED = dict(B=4, S=512)
GRAD_ROW_TOL = 1e-2
GRAD_FLOOR = 1e-4
GRAD_FRO_TOL = 1e-2
# QLoRA training, bench_train.py --flagship's recipe: int8 frozen base,
# LoRA r16 x 4 on wq / wv, B2 x S2048, remat. The learning rate is 1e-3
# after a 2-step warm-up (the bench's 1e-4 moves few bf16 values in 8
# steps; the rate does not change the time of a step)
TRAIN = dict(B=2, S=2048, soft_tokens=8, lora_rank=16, lora_experts=4,
             warm=2, small=2, big=6, lr=1e-3, warmup=2)
# the training check: card bf16 against CPU f32, 2 layers, vocab 8192;
# LoRA B ~ N(0, 0.02^2) so that the gradient of A does not vanish
TRAIN_SMALL = dict(layers=2, vocab=8192, B=2, S=256)
TRAIN_SMALL_B = 0.02
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_COS = 0.99
TRAIN_UPDATE_COS = 0.9
# the card's parameters after the update against the same update in f32
# from the card's start and gradients: bf16 moments move an Adam step (lr)
# by a few percent; an update left out is 1 lr off, a flipped one 2
TRAIN_PARAM_STEPS = 0.25
# kernel row 7 (RMSNorm + W8A8 SwiGLU MLP + residual) at the Bind prefill's
# MLP (B16 x L256 rows, Llama d 4096, I 11008) and at Llama-3-8B's I 14336.
# Kernel against plain, per element in units of the step one hidden code
# moves it, step[r, c] = max_j sa[r, j] * max_k |wd.q[k, c]| * wd.s[c]: the
# error beyond one bf16 ulp of the plain value is at most SWIGLU_STEPS
# steps, and at most SWIGLU_OFF_ULP of the elements are more than one ulp
# off. The plain version sums a row's squares in another order, so an
# input code can flip at a tie; that moves every hidden value of its row by
# about one part in 127 sqrt(d) and flips the hidden codes that lay that
# close to a tie, whose steps add with random signs (this check read 9.1
# and 8.7 steps at I 11008 and 14336 on an H100 80GB HBM3 at 700 W); a
# group's scale doubled or a row tile left out is hundreds of steps off
SWIGLU_SHAPES = ((4096, 4096, 11008), (4096, 4096, 14336))
SWIGLU_STEPS = 16.0
SWIGLU_OFF_ULP = 1e-2
SWIGLU_ROW_TILE = 128      # rows of a tile of the up and down kernels
# the bias add + erf-GELU pair (csrc/gelu_erf.cu) at ESM2-3B's index call:
# 128 rows of 1,026 (112 proteins bucketed) x the MLP's 10,240, bf16 with
# bias; the forward within one bf16 ulp of the plain chain and at least
# GELU_SAME of the elements the same bits, the backward within one ulp plus
# 2^-20 |g| of autograd of the plain chain (the analytic derivative and the
# chain round otherwise where its two terms cancel) and at least
# GELU_SAME_BWD the same bits, as tests/test_torch_cuda_kernels.py holds
# them; the chain's autograd keeps about 13 f32 copies of its input, so the
# backward is held to it GELU_BWD_PARTS row blocks at a time
GELU_SHAPE = dict(M=128 * 1026, F=10240)
GELU_SAME = 0.999
GELU_SAME_BWD = 0.99
GELU_BWD_PARTS = 4
# the W8A8 prefill path (bench_bind / bench_retrieval / bench_prefill at
# the reference's defaults): a 2-layer copy on the card (bf16) against the
# CPU (f32), both W8A8. bf16 rounding of an activation flips its int8 code
# where it lies within 2^-9 of a tie, and the flip moves its whole row, so
# W8A8 in bf16 drifts from f32 more than weight-only does (this check read
# a yes-probability 0.031 off and an embedding cosine of 0.9982 on an
# H100 80GB HBM3 at 700 W): the yes-probabilities within
# W8A8_SMALL_PROB_ATOL, the embeddings' cosine at least SANITY_COS. The
# readout is held by the logits at the answer position: each row's
# cosine to the CPU's (centred over the vocabulary) at least SANITY_COS,
# and the yes / no log-odds within READOUT_LOGODDS_REL of the CPU's
# largest |log-odds| (a relative logit error of a few percent gives a
# tenth of that); the answer read one position early, or yes and no
# swapped, must fail that check. Then full width, W8A8 against bf16 on
# the same seeded weights. What is gated there follows the reference's
# doctrine for random weights (procyon_tpu/evaluate/quant_quality.py):
# distribution-level numbers, not logit-space ones. The Bind answer's
# distribution over the vocabulary (bind_ce_delta: the W8A8 decoder's
# cross-entropy under the bf16 decoder's minus the bf16 entropy, mean over
# the 16 pairs) is held to the reference's W8A8 bound,
# CE_DELTA_GATES[("int8", "w8a8")], and the retrieval embeddings' cosine
# to SANITY_COS; a doubled activation scale in one layer's W8A8 products
# must fail one of them. The yes-probability gap is reported only: at 30
# random-weight layers it moves across 0.05 with the attention's rounding
# alone (0.0248 with one flash kernel, 0.0597 with another, 0.0676 and
# 0.0503 with the forward's plain version, P rounded to bf16 and not)
W8A8 = dict(B=16, L=256, targets=57000, prefill_B=4, prefill_S=2048)
W8A8_SMALL_LAYERS = 2
W8A8_SMALL_PROB_ATOL = 0.1
READOUT_LOGODDS_REL = 0.25
W8A8_FAULT_LAYER = 15      # the layer whose activation scale is doubled
QA_EVAL_ROWS = 16
# the retrieval eval at ProCyon-Full width on the /retrieve service: 64
# query texts of a disgenet retrieval task in batches of 16 against every
# protein, 1-5 eval positives and 2 train relations (leaks, NaN-masked) a
# query drawn from a seed, the full RetrievalEvalConfig
RETRIEVAL_EVAL = dict(task="disgenet_all_retrieval", queries=64, batch=16,
                      positives=(1, 6), train=2, direct_rows=4)
# the card (bf16) against the CPU (f32) on ProcyonRetrievalEval's cosine
# matrix at ProCyon-Full widths cut to 2 layers (vocabulary 8192 for this
# check only). A score is the cosine of a query and a target embedding;
# bf16 turns each by a small angle, and the score moves by at most the sum
# of the two angles. The fusion check's query embedding reads a cosine of
# 0.999942 to the CPU's at these widths (an H100 80GB HBM3 at 700 W), an
# angle of 0.011 rad; a target (one projector layer) turns less. So twice the angle of a cosine of 0.9999 (0.0141 rad) bounds a
# score with room; the columns in another target order must fail it
RETRIEVAL_SMALL = dict(layers=2, vocab=8192, queries=4, proteins=512)
RETRIEVAL_SMALL_ATOL = 2 * math.acos(0.9999)
# the 64 eval scores of the first rows against one direct query embedding
# of the same batch and the service's table, both f32 products on the card
DIRECT_SCORE_ATOL = 1e-4
# the mid-train eval (training/evaluation.build_midtrain_eval) in cell f:
# val-split go / process QA and retrieval streams, batch 2
MIDTRAIN = dict(n_batches=2, targets=4096, batch=2)
EVAL_CLI_MODELS = ("procyon", "knn", "mlp", "random")
# the BERT slice (slice 6b). BERTScore's en-sci scorer at the width of
# allenai/scibert_scivocab_uncased's published config (vocab 31090, 768
# wide, 12 layers of 12 heads, 512 positions) reading layer 8, bert_score's
# pick for scibert; 512 candidate captions against 3 references each in
# chunks of 64 pairs, texts of 30-400 WordPiece tokens from a seeded word
# list (most chunks hold pad rows and key tiles of padding alone)
SCIBERT = dict(vocab_size=31090, dim=768, n_layers=12, n_heads=12,
               max_position=512)
PUBMEDBERT = dict(vocab_size=30522, dim=768, n_layers=12, n_heads=12,
                  max_position=512)
BERTSCORE = dict(candidates=512, refs=3, batch=64, layer=8,
                 tokens=(30, 400), baseline_pairs=1000, words=20000)
# the 2-layer copy of that scorer on the card (bf16) against the CPU (f32)
# on 64 pairs whose references share most of their candidate's words: P, R
# and F1 within BERTSCORE_SMALL_ATOL, 20x the 5.1e-05 that sound runs read
# (PERF.md, PR 16). Three planted faults must fail it: the references in
# reverse order (the host's matching), every pad key attended (the
# encoder's mask) and layer 1 read in place of layer 2 (the encoder's
# depth)
BERTSCORE_SMALL = dict(layers=2, pairs=64)
BERTSCORE_SMALL_ATOL = 1e-3
# row 3 at BERT's shape: B128 S512 H12 D64, bidirectional, right-padded to
# lengths drawn as BERTScore's texts (30-400 tokens) and some full rows
BERT_FLASH = dict(B=128, S=512, H=12, D=64)
# the text baselines through run_evaluation at full width: a synthetic
# store of 2,000 proteins (100-500 residues), 64 retrieval queries (1-5
# positives each) and 64 QA pairs; ESM2-650M, PubMedBERT-base, the
# BioTranslator CNN at CNNConfig's defaults, Llama-2-7B's width for
# ProtLLM; towers in bf16
BASELINE_STORE = dict(proteins=2000, queries=64, qa=64, min_len=100,
                      max_len=500)
BASELINE_MODELS = ("pubmedbert", "simcse", "biotranslator", "protst",
                   "protllm")
# each baseline's scores with BERT, ESM2 and Llama cut to 2 layers (the CNN
# whole) on the card in bf16 against the CPU in f32: 8 query texts x 8
# target proteins (cosines) or 8 QA pairs (yes-probabilities), each within
# its BASELINE_SMALL_ATOL, about 10x what sound runs read (PERF.md, PR 16:
# 4.2e-05, 5.1e-05, 3.1e-04, 5.4e-04, 4.4e-03); ProtLLM with the protein
# spliced into the BOS row in place of <|protein|>'s must fail it
BASELINE_SMALL = dict(layers=2, queries=8, targets=8, qa=8)
BASELINE_SMALL_ATOL = dict(pubmedbert=5e-4, simcse=5e-4, biotranslator=5e-3,
                           protst=5e-3, protllm=2e-2)
# the live-encoder slice (slice 1 remainder) at ProCyon-Full width: ESM2-3B
# (configs/llama3-full.yml's protein encoder: d 2560, 36 layers, H40 D64)
# fine-tuned with MoLoRA r8 (aaseq_lora_r, aaseq_lora_alpha 8) on all six
# projections, 4 experts under lora_phase_training, beside phase_train's
# int8 QLoRA decoder; MLM batches of 8 proteins x 1024 residues (1,026
# tokens) drawn from a synthetic FASTA of 20,000 proteins (cell b's target
# set) whose lengths run 50-1024 residues with a quarter longer (truncated)
ESM_TRAIN = dict(lora_rank=8, lora_alpha=8.0, experts=4, targets="default",
                 mlm_batch=8, max_len=1024, warm=2, timed=4, lr=1e-3,
                 warmup=2)
ESM_DATA = dict(proteins=20000, lengths=(50, 1024), long=0.25, reads=2000)
# rows 3, 8 and 9 at ESM2-3B's training attention and with a prefix
ESM_FLASH = dict(B=8, S=1026, H=40, D=64, P=16)
# the trained encoder served: merged, int8, fused QKV, W8A8 (rows 1 and 4)
ESM_SERVE = dict(B=16, S=1024)
# one MLM loss and the gradients of the banks, prefix and adapter at
# ESM2-3B width cut to 2 layers, card bf16 against CPU f32; the loss's
# relative error and 1 - the least gradient cosine each within about 10x
# what sound runs read (at most 5.2e-04 and 9.1e-05 over the three
# variants on an H100 80GB HBM3 at 700 W); the expert index off by one (1 -
# cosine 1.0) and the prefix keys rotated by position (0.24) must fail it
ESM_SMALL = dict(layers=2, residues=(250, 190, 96), expert=2, b_scale=0.02,
                 variants={"lora": {}, "prefix": {"prefix_len": 16},
                           "adapter": {"adapter_rank": 64}})
ESM_SMALL_LOSS_RTOL = 5e-3
ESM_SMALL_COS = 1e-3
# the bench scripts at full width (the "benches" group). bench_decode
# --paged at ProCyon-Split's Llama-2-7B dim and depth (4096 x 32 layers;
# the script's rule gives 32 query and 16 kv heads, I 11008, vocab 32000):
# 16 rows of 512-token prompts
# (prompt + gen_big + 8 = 544 tokens a slot, 9 pages of 64: a pool of at
# least 512 tokens a slot takes the paged attention kernel), 8 and 24
# steps; bench_caption at ProCyon-Full's Llama-3-8B in int4, paged, the
# cascade and the flat page walk timed in one run (--cascade ab: the
# flat arm runs row 10, whose pool needs 448-token prompts to reach 512
# tokens a slot), 8 and 24 steps
BENCH_DECODE = ("--dim", "4096", "--layers", "32", "--batch", "16",
                "--prompt_len", "512", "--gen_small", "8", "--gen_big", "24",
                "--paged")
BENCH_CAPTION = ("--llama3", "--bits", "4", "--paged", "--cascade", "ab",
                 "--prompt_len", "448", "--gen_small", "8", "--gen_big",
                 "24")
RETRIEVE_CLI_K = 10
# utils/trace.device_op_table on a traced run of row 3 at the training
# shape: its launches counted, its time a launch within TRACE_RTOL of the
# CUDA-event time
TRACE_LAUNCHES = 20
TRACE_RTOL = 0.25


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


def decode_bound_ms(M):
    """Row 14's least time at M rows: the three int8 weights, their f32
    scales, x, the norm weight and the output, against the bf16 products
    of the gate, up and down matrices."""
    d, I = DECODE_SHAPE["d"], DECODE_SHAPE["I"]
    n_bytes = 3 * d * I + 4 * (2 * I + d) + 2 * (2 * M * d + d)
    return bound(n_bytes, 2 * M * 3 * d * I, PEAK_BF16)


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


def sdpa_ms(q, k, v, ok, kernel_out, is_causal=False):
    """Time F.scaled_dot_product_attention (the library call, used nowhere
    in the port) on q [B, Sq, Hq, D], k / v [B, Skv, Hkv, D] under the
    boolean mask ok [B, Sq, Skv], or with is_causal=True and no mask where
    ok is the causal mask alone (its fastest route); its live rows must
    agree with the kernel's."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(is_causal=True) if is_causal else dict(attn_mask=ok[:, None])
    gqa = qt.shape[1] != kt.shape[1]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=gqa,
                                              **kw)

    lib = call().transpose(1, 2)
    live = ok.any(-1)
    diff = (lib[live].float() - kernel_out[live].float()).abs().max().item()
    check(diff <= LIBRARY_ATOL, "scaled_dot_product_attention is "
          f"{diff} from the kernel on live rows (> {LIBRARY_ATOL})")
    return cuda_ms(call)


def phase_build():
    from procyon_tpu_torch.ops import _build
    names = ("rowblock_attention", "fused_ln_mlp_int8", "flash_attention_fwd",
             "page_move", "paged_attention", "int4_matmul",
             "flash_attention_bwd", "fused_decode_mlp",
             "fused_rms_swiglu_int8", "gelu_erf")
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
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "wgmma")):
                print(f"  ptxas {name}: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(names)} sources "
          f"in parallel ({_build.BUILD_DIR})")


def phase_attention(dev, B, H=ATTN_SHAPE["H"], S=ATTN_SHAPE["S"]):
    import torch
    from procyon_tpu_torch.ops import attention_rowblock as rb
    from procyon_tpu_torch.ops.rotary import flat_rotary_tables
    D = ATTN_SHAPE["D"]
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
    check(torch.equal(out, kernel()), "attention: two launches on the same "
                                      "inputs differ")
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
          f"over {pairs} allowed pairs, {n_bytes / 1e6:.1f} MB); two "
          "launches bitwise equal")
    return dict(name="rowblock_attention", route="cuda",
                source="procyon_tpu_torch/csrc/rowblock_attention.cu",
                replaces="procyon_tpu/ops/attention_rowblock.py:274",
                shape=f"B{B} S{S} H{H} D{D}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def esm2_mlp_route(args, eps=1e-5):
    """The port's unfused W8A8 route for the same layer (esm2._mlp with
    quant_mode "w8a8"): LayerNorm, qmatmul_w8a8 with W1 (row quantization,
    torch._int_mm, the scale epilogue), the erf GELU, qmatmul_w8a8 with W2,
    the residual. A route of several calls, not one PyTorch call: it is
    timed beside rows 4 and 6 as row 7's route is beside row 7."""
    from procyon_tpu_torch.models import esm2
    x, lnw, lnb, w1q, s1, b1, w2q, s2, b2 = args
    lp = {"mlp_norm": {"w": lnw, "b": lnb},
          "mlp": {"w1": {"q": w1q, "s": s1}, "b1": b1,
                  "w2": {"q": w2q, "s": s2}, "b2": b2}}
    return esm2._mlp(x, lp, esm2.ESM2Config(dim=x.shape[1], norm_eps=eps,
                                            quant_mode="w8a8"))


def mlp_stage_codes(kind, args):
    """The hidden codes and scales the int8 MLP kernels of `kind` pass
    between them, against the plain up stage (fused_mlp.gelu_codes_ref) run
    on the kernels' own row codes: the codes that differ (a rounding tie
    may take the neighbouring code), by how much, and the scales' largest
    relative difference."""
    from procyon_tpu_torch.ops import fused_mlp as fm
    _, (xq, sx, gq, sg) = fm._launch_mlp(kind, *args, 1e-5, False)
    G = fm.kernel_shape(kind, *xq.shape, args[3].shape[1])[0]
    own, own_sg = fm.gelu_codes_ref(xq, sx, *args[3:6], G)
    diff = (gq.int() - own.int()).abs()
    codes = dict(gq=int((diff > 0).sum().item()), gq_of=gq.numel(),
                 gq_max=int(diff.max().item()),
                 sg_rel=((sg - own_sg).abs() / own_sg).max().item())
    check(codes["gq_max"] <= 1 and codes["gq"] <= CODE_FLIPS * gq.numel()
          and codes["sg_rel"] <= SX_RTOL,
          f"{kind} int8 MLP: hidden codes against the plain stage {codes}")
    return codes


def phase_mlp(dev, M, d=MLP_SHAPE["d"], H=MLP_SHAPE["H"]):
    import torch
    from procyon_tpu_torch.ops import fused_mlp as fm
    from procyon_tpu_torch.ops import quant
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
    # the weights as the ESM2 serving layout holds them (esm2.fuse_qkv_params:
    # [in, out] views of [out, in] storage, which the kernels read as is)
    w1q, w2q = (w["q"].t().contiguous().t() for w in (w1, w2))
    args = (x, lnw, lnb, w1q, w1["s"], b1, w2q, w2["s"], b2)
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
    check(torch.equal(out, fm.fused_ln_mlp_int8(*args, add_residual=True)),
          "mlp: two launches on the same inputs differ")
    codes = mlp_stage_codes("one_pass", args)
    cos = mlp_cos(out, esm2_mlp_route(args), x)
    check(cos >= SANITY_COS, f"mlp: MLP cosine {cos} to the W8A8 route")

    def kernel():
        return fm.fused_ln_mlp_int8(*args, add_residual=True)

    ms, plain_ms = paired_ms(
        kernel, lambda: fm.fused_ln_mlp_int8_ref(*args, add_residual=True))
    route_ms = cuda_ms(lambda: esm2_mlp_route(args))
    split = device_ms_by_kernel(kernel, MLP_KERNELS)
    n_bytes = nbytes(*args) + nbytes(out)
    ops = 4 * M * d * H            # two int8 products of 2*M*d*H each
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_INT8)
    print(f"fused mlp M{M} d{d} H{H} G{fm.requant_group(H)}: max_abs_err "
          f"{errs[0]:.3e} / {errs[1]:.3e} (no residual / residual; tol "
          f"{ATOL} + {RTOL}|plain|, mean {MLP_MEAN_TOL}); two launches "
          f"bitwise equal; hidden codes against the plain stage on the "
          f"kernels' own row codes: {codes['gq']} of {codes['gq_of']} differ "
          f"(by at most {codes['gq_max']}), scales within "
          f"{codes['sg_rel']:.1e}; MLP cosine to the W8A8 route {cos:.6f}; "
          f"kernels {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s; device time: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"), plain {plain_ms:.4f} ms, W8A8 route (several calls) "
          f"{route_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({ops / 1e9:.1f} GOP, {n_bytes / 1e6:.1f} MB); no single "
          "PyTorch call computes it")
    return dict(name="fused_ln_mlp_int8", route="cuda",
                source="procyon_tpu_torch/csrc/fused_ln_mlp_int8.cu",
                replaces="procyon_tpu/ops/fused_mlp.py:368",
                shape=f"M{M} d{d} H{H}", max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, route_ms=route_ms, cos_route=cos,
                device_ms=split, codes=codes)


def flash_case(name, q, k, v, seg_q, seg_kv, *, causal, q_pos=None,
               kv_pos=None, through_rowblock=False):
    """One shape of the flash kernel: against its plain version (out, and
    lse on live rows), dead rows exactly 0, two launches bitwise equal,
    times for kernel, plain version and the library call (with
    is_causal=True and no mask where nothing is padded), and the bound from
    this run's masks (operations over the allowed pairs; bytes of the live
    q, k and v rows, of out, lse and the four int arrays)."""
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
    again = kernel()
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"{name}: two launches on the same inputs differ")
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
    unpadded = causal and seg_q is None and seg_kv is None and q_pos is None
    library_ms = sdpa_ms(q, k, v, ok, out, is_causal=unpadded)
    n_bytes = (live_bytes(q, ints[0]) + live_bytes(k, ints[1])
               + live_bytes(v, ints[1]) + nbytes(out, lse, *ints))
    ops = 4 * D * Hq * pairs
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_BF16)
    shape = f"B{B} Sq{Sq} Skv{Skv} Hq{Hq} Hkv{Hkv} D{D}"
    print(f"{name} {shape} {'causal' if causal else 'bidirectional'}: "
          f"max_abs_err {err:.3e}, lse err {lse_err:.3e} (tol {ATOL} + "
          f"{RTOL}|plain|, lse {LSE_TOL}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms"
          f"{' (is_causal, no mask)' if unpadded else ''}, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.3f} GFLOP over "
          f"{pairs} allowed pairs, {n_bytes / 1e6:.1f} MB); two launches "
          "bitwise equal")
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


def flash_fit(dev):
    """Row 3's time split into a cost per block item and a cost per tile
    pair (128 query rows against 128 keys, both warpgroups): the forward,
    bidirectional and unpadded at Llama-3-8B widths, over 4 and 16 key
    tiles an item (B16 S512 and B2 S2048: 8,192 and 16,384 tile pairs),
    timed with CUDA events; per SM, time = items x F + pairs x T."""
    import torch
    from procyon_tpu_torch.ops import flash_attention as fa
    Hq, Hkv, D = (FLASH_SHAPE[k] for k in ("Hq", "Hkv", "D"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = []
    for B, S in ((16, 512), (2, 2048)):
        q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(
            torch.bfloat16) for H in (Hq, Hkv, Hkv))
        ints = fa.mask_inputs(q, k, None, None, None, None)
        ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, *ints, causal=False,
                                          sm_scale=D ** -0.5, bounded=True),
                     iters=20, warmup=3)
        items = S // 128 * Hq * B
        pairs = items * (S // 128)
        rows.append((ms * 1e3, items / sms, pairs / sms))
    (t1, i1, p1), (t2, i2, p2) = rows
    # the wall time in us = items an SM x F + tile pairs an SM x T, twice
    T = (t2 * i1 - t1 * i2) / (p2 * i1 - p1 * i2)
    F = (t1 - p1 * T) / i1
    print(f"flash fit (bidirectional, Hq{Hq} Hkv{Hkv} D{D}, {sms} SMs): "
          f"B16 S512 {t1 / 1e3:.4f} ms, B2 S2048 {t2 / 1e3:.4f} ms; "
          f"{F:.2f} us an item (fixed), {T:.3f} us a tile pair an SM (the "
          f"products alone at 989 TFLOP/s: "
          f"{2 * 2 * 128 * 128 * D / 989e12 * sms * 1e6:.3f} us)")
    return dict(item_us=F, tile_pair_us=T, ms_b16=t1 / 1e3,
                ms_b2_s2048=t2 / 1e3)


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


def phase_flash_train(dev):
    """Row 3 at the shape every layer of the QA train step gives it: B2 x
    S2048 at Llama-3-8B widths, causal, nothing padded."""
    import torch
    B, S = FLASH_BWD_TRAIN["B"], FLASH_BWD_TRAIN["S"]
    Hq, Hkv, D = (FLASH_SHAPE[k] for k in ("Hq", "Hkv", "D"))
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(
        torch.bfloat16) for H in (Hq, Hkv, Hkv))
    return flash_case("flash (training shape)", q, k, v, None, None,
                      causal=True)


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
                     profile=False):
    """bench.py's workload through scripts/bench_w8a8.py's `run`: B64 rows
    of L512 with random lengths in [L/2, L-2) (`tokens_batch`), the ESM2
    forward + mean pooling, bf16 and W8A8 with fused QKV on the main
    path's weights, each timed by utils/timing.time_fn (CUDA events, two
    points, the best of two runs each); the row-block attention (row 1) once a layer in both routes
    and the fused LN + int8 MLP (row 4) once a layer in the W8A8 route.
    With `profile`, one W8A8 batch under torch.profiler."""
    import torch
    from procyon_tpu_torch.scripts import bench_w8a8
    tokens = bench_w8a8.tokens_batch(batch, seq_len, SEED, device=dev)
    res = bench_w8a8.run(params["esm"], cfg.esm, params8=params8["esm"],
                         device=dev, tokens=tokens)
    n = cfg.esm.n_layers
    want = {"bf16": {"rowblock_attention": n, "fused_ln_mlp_int8": 0},
            "w8a8": {"rowblock_attention": n, "fused_ln_mlp_int8": n}}
    for route, counts in want.items():
        got = {k: res["launches"][route][k] for k in counts}
        check(got == counts, f"bench_w8a8 {route}: launches {got}, "
                             f"expected {counts}")
    check(res["finite"], "bench_w8a8: non-finite embeddings")
    rates, cos_min = res["proteins_per_sec"], res["cos_min"]
    check(cos_min >= SANITY_COS, f"bench_w8a8 cos_min {cos_min}")
    print(f"throughput B{batch} L{seq_len} (scripts/bench_w8a8.py): bf16 "
          f"{rates['bf16']:.2f} proteins/s, W8A8 {rates['w8a8']:.2f} "
          f"proteins/s; pooled-hidden cos_min {cos_min:.6f} (bench.py's "
          f"metric); launches a call {res['launches']}")
    print(json.dumps(res["line"]))
    if profile:
        with torch.no_grad():
            profile_once(f"one W8A8 ESM2-650M batch (B{batch} L{seq_len})",
                         lambda: bench_w8a8.embed(params8["esm"], cfg8.esm,
                                                  tokens),
                         batch / rates["w8a8"] * 1e3)
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


def synthetic_service(dev):
    """The synthetic ProCyon-Full service on the card: random weights from
    the app's seed, the synthetic protein table embedded."""
    import torch
    from procyon_tpu_torch.app import main as app_main
    os.environ["PROCYON_SYNTHETIC"] = "1"
    service = app_main._build_service(device=dev)
    torch.cuda.synchronize()
    return service


def phase_retrieve(dev, profile):
    """The slice's main path: the synthetic ProCyon-Full service on the
    card behind the stdlib HTTP server, five POST /retrieve requests."""
    import numpy as np
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.app import main as app_main
    from procyon_tpu_torch.app import server
    from procyon_tpu_torch.data.collators import CollatorConfig
    from procyon_tpu_torch.inference import prompts
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import (attention_rowblock, flash_attention,
                                       fused_mlp)
    t0 = time.perf_counter()
    service = synthetic_service(dev)
    lcfg = service.cfg.llama
    n_params = sum(t.numel() for t in bridge.tree_leaves(service.params))
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


def direct_moves(dev, N, M, g):
    """One beam step's M moves over N rows: distinct destinations, sources
    that repeat (children of one parent) and never are destinations."""
    import torch
    perm = torch.randperm(N, generator=g, device=dev)
    dst = perm[:M].to(torch.int32)
    src = perm[M:][torch.randint(0, M // 4, (M,), generator=g,
                                 device=dev)].to(torch.int32)
    return src, dst


@functools.cache
def copy_rate(dev):
    """(ms, TB/s) of one `Tensor.copy_` of a 1 GiB buffer, counting the
    bytes read and written: the card's copy rate, measured once a run."""
    import torch
    a = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    ms = cuda_ms(lambda: b.copy_(a), iters=20, warmup=3)
    tbs = 2 * 2 ** 30 / ms / 1e9
    del a, b
    torch.cuda.empty_cache()
    print(f"Tensor.copy_ of 1 GiB: {ms:.4f} ms, {tbs:.3f} TB/s counting "
          f"read and write bytes ({tbs * 1e12 / PEAK_BYTES:.1%} of "
          f"{PEAK_BYTES / 1e12:.2f} TB/s)")
    return ms, tbs


def rate_shares(n_bytes, ms, dev):
    """A byte-bound kernel's rate as shares of the card's copy rate and of
    the published memory rate."""
    tbs = n_bytes / ms / 1e9
    return dict(tb_s=tbs, copy_share=tbs / copy_rate(dev)[1],
                peak_share=tbs * 1e12 / PEAK_BYTES)


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
    src, dst = direct_moves(dev, N, M, g)
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
                bound_by=bound_by, library_ms=library_ms,
                **rate_shares(n_bytes, ms, dev))
        del pool, got
        torch.cuda.empty_cache()
    return result


def staged_moves(dev, N, M, g):
    """M moves over N rows with distinct destinations whose sources hold a
    swap, a 3-cycle, a chain (a row that is a source and a destination),
    64 destinations moved among themselves, and sources that repeat; in a
    random order, so that a move that reads a row another one writes is
    mostly far from it in the grid, where a copy without staging reads
    the row after it was written."""
    import torch
    p = torch.randperm(N, generator=g, device=dev)
    dst = p[:M]
    src = torch.cat([
        p[torch.tensor([1, 0, 3, 4, 2, M + 7, 5], device=dev)],
        p[7:71][torch.randperm(64, generator=g, device=dev)],
        p[M:][torch.randint(0, M // 4, (M - 71,), generator=g, device=dev)]])
    order = torch.randperm(M, generator=g, device=dev)
    return src[order].to(torch.int32), dst[order].to(torch.int32)


def phase_staged_move(dev):
    """The staged page move (kernel row 11) at the caption path's shape:
    the session's bf16 pool (32 layers x 881 pages of [64, 1024]), 2,560
    moves whose sources overlap their destinations (staged_moves), then an
    int8 pool and an f32 scale slab [.., 64, 8]. Its path: the three moves,
    counted; each equal to the plain version, exactly, and two launches on
    copies of the pool the same bits. Interpret mode on the CPU cannot
    tell a kernel that writes before every source is read, so this is the
    check of that order."""
    import torch
    from procyon_tpu_torch.ops import page_move as pm
    L, n_pages, page, KD = (POOL_SHAPE[k] for k in ("L", "n_pages", "page",
                                                    "KD"))
    N, M = L * n_pages, PAGE_MOVES
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    src, dst = staged_moves(dev, N, M, g)
    check(torch.isin(src, dst).any().item()
          and src.unique().numel() < M, "staged move: the plan has no "
                                        "overlap or no repeated source")
    slabs = {dtype: torch.randint(-100, 100, (N, *tail), generator=g,
                                  device=dev, dtype=torch.int32).to(dtype)
             for dtype, tail in ((torch.bfloat16, (page, KD)),
                                 (torch.int8, (page, KD)),
                                 (torch.float32, (page, KD // 128)))}
    starts = {dtype: pool.clone() for dtype, pool in slabs.items()}
    pm.launches_staged = 0
    for pool in slabs.values():
        pm.move_pages(pool, src, dst)
    torch.cuda.synchronize()
    path_launches = pm.launches_staged
    check(path_launches == len(slabs), f"staged move: {path_launches} "
          f"launches on its path, not {len(slabs)}")
    n_staged = pm.staging_plan(src, dst, N)[0].numel()
    result = None
    for dtype, pool in slabs.items():
        start = starts.pop(dtype)
        want = pm.move_pages_ref(start.clone(), src, dst)
        check(torch.equal(pool, want),
              f"staged page move ({dtype}): differs from the plain version")
        again = pm.move_pages(start.clone(), src, dst)
        check(torch.equal(again, pool), f"staged page move ({dtype}): two "
                                        "launches on the same pool differ")
        del again
        # the same plan through the direct kernel, which copies without
        # staging: the check above would have seen that order
        pm.move_pages_direct(start, src, dst)
        check(not torch.equal(start, want), "staged move: the plan does "
              "not tell a copy without staging from the staged one")
        del want, start
        ms, plain_ms = paired_ms(lambda: pm.move_pages(pool, src, dst),
                                 lambda: pm.move_pages_ref(pool, src, dst))
        srcl, dstl = src.long(), dst.long()
        library_ms = cuda_ms(lambda: pool.index_copy_(
            0, dstl, pool.index_select(0, srcl)))
        row_bytes = pool[0].numel() * pool.element_size()
        n_src = src.unique().numel()
        n_bytes = (n_src + M) * row_bytes + nbytes(src, dst)
        bound_ms, bound_by = bound(n_bytes, 0, PEAK_BF16)
        name = str(dtype).split(".")[1]
        shares = rate_shares(n_bytes, ms, dev)
        print(f"staged page move {name} pool {list(pool.shape)}, {M} moves "
              f"of {row_bytes} bytes, {n_src} distinct sources, swap, "
              f"3-cycle, chain and 64 destinations permuted ({n_staged} rows "
              f"staged): equal to the plain version (the in-place copy is "
              f"not), two launches the same bits; kernel {ms:.4f} ms (one "
              f"launch), plain {plain_ms:.4f} ms, index_select + "
              f"index_copy_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({n_bytes / 1e6:.1f} MB; {shares['copy_share']:.1%}"
              f" of the copy rate, {shares['peak_share']:.1%} of "
              f"{PEAK_BYTES / 1e12:.2f} TB/s)")
        if result is None:
            result = dict(
                name="page_move_staged", route="cuda",
                source="procyon_tpu_torch/csrc/page_move.cu",
                replaces="procyon_tpu/ops/page_move.py:46",
                shape=f"pool [{N}, {page}, {KD}] bf16, {M} overlapping "
                      f"moves, {n_staged} rows staged", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, **shares)
    del slabs, pool
    torch.cuda.empty_cache()
    result["path_launches"] = path_launches
    return result


def esm3b_mlp_args(dev, M, seed):
    """ESM2-3B's MLP at M rows: bf16 x, f32 LayerNorm affine (the row
    pass's operands as the reference hands them to its kernel), int8
    weights, bf16 biases."""
    import torch
    from procyon_tpu_torch.ops import quant
    d, H = ESM3B_MLP["d"], ESM3B_MLP["H"]
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    w1 = quant.quantize(randn(d, H, scale=d ** -0.5))
    w2 = quant.quantize(randn(H, d, scale=H ** -0.5))
    return (randn(M, d).to(torch.bfloat16), 1 + randn(d, scale=0.1),
            randn(d, scale=0.1), w1["q"], w1["s"],
            randn(H, scale=0.1).to(torch.bfloat16), w2["q"], w2["s"],
            randn(d, scale=0.1).to(torch.bfloat16))


def phase_prequant_mlp(dev):
    """Kernel rows 5 and 6 at ESM2-3B's MLP (d 2560, H 10240) on a B64 x
    L512 batch (32768 rows): the LN + row quantization against its plain
    version (codes equal but at rounding ties, at most CODE_FLIPS of them
    and each by one step; scales within SX_RTOL; two launches the same
    bits) and its share of the card's copy rate, the two-pass MLP with
    and without the residual within the one-pass kernel's tolerance, two
    launches bitwise equal, its hidden codes against the plain stage, and
    its time beside the port's W8A8 route for the same layer."""
    import torch
    from procyon_tpu_torch.ops import fused_mlp as fm
    M = ESM3B_MLP["M"]
    args = esm3b_mlp_args(dev, M, SEED + 23)
    x, lnw, lnb = args[:3]
    d, H = x.shape[1], args[3].shape[1]
    xq, sx = fm.ln_quant_rows(x, lnw, lnb)
    rq, rs = fm.ln_quant_rows_ref(x, lnw, lnb)
    again = fm.ln_quant_rows(x, lnw, lnb)
    torch.cuda.synchronize()
    check(torch.equal(again[0], xq) and torch.equal(again[1], sx),
          "ln_quant_rows: two launches on the same inputs differ")
    del again
    diff = (xq.int() - rq.int()).abs()
    flips = (diff > 0).float().mean().item()
    sx_err = ((sx - rs).abs() / rs).max().item()
    check(diff.max().item() <= 1 and flips <= CODE_FLIPS
          and sx_err <= SX_RTOL, f"ln_quant_rows: {flips} of the codes "
          f"differ (largest {diff.max().item()}), scales {sx_err} relative")
    ms, plain_ms = paired_ms(lambda: fm.ln_quant_rows(x, lnw, lnb),
                             lambda: fm.ln_quant_rows_ref(x, lnw, lnb))
    n_bytes = nbytes(x, lnw, lnb, xq, sx)
    bound_ms, bound_by = bound(n_bytes, 0, PEAK_INT8)
    shares = rate_shares(n_bytes, ms, dev)
    print(f"LN + row quantization M{M} d{d}: {flips:.2e} of the codes "
          f"differ by one (tol {CODE_FLIPS}), scales within {sx_err:.2e} "
          f"(tol {SX_RTOL}), two launches the same bits; kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({n_bytes / 1e6:.1f} MB; {shares['copy_share']:.1%} "
          f"of the copy rate, {shares['peak_share']:.1%} of "
          f"{PEAK_BYTES / 1e12:.2f} TB/s); no single PyTorch call computes "
          "it")
    rows = dict(name="ln_quant_rows", route="cuda",
                source="procyon_tpu_torch/csrc/fused_ln_mlp_int8.cu",
                replaces="procyon_tpu/ops/fused_mlp.py:203",
                shape=f"M{M} d{d}", max_abs_err=float(diff.max().item()),
                code_flips=flips, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                **shares)
    del rq, rs, diff
    errs = []
    for residual in (False, True):
        out = fm.fused_mlp_int8_prequant(*args, add_residual=residual)
        ref = fm.fused_mlp_int8_prequant_ref(*args, add_residual=residual)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        check(torch.isfinite(out.float()).all().item(),
              "two-pass mlp: non-finite")
        errs.append(err.max().item())
        check(within_tol(out, ref) and err.mean().item() <= MLP_MEAN_TOL,
              f"two-pass mlp (residual={residual}): max_abs_err {errs[-1]}, "
              f"mean {err.mean().item()}")
        del ref, err

    def two_pass():
        return fm.fused_mlp_int8_prequant(*args, add_residual=True)

    check(torch.equal(out, two_pass()),
          "two-pass mlp: two launches on the same inputs differ")
    codes = mlp_stage_codes("two_pass", args)
    cos = mlp_cos(out, esm2_mlp_route(args), x)
    check(cos >= SANITY_COS, f"two-pass mlp: MLP cosine {cos} to the W8A8 "
                             "route")
    del out
    split = device_ms_by_kernel(two_pass, MLP_KERNELS[1:], reps=3)
    ms_pq = sum(split.values())
    total_ms, plain_ms = paired_ms(
        two_pass, lambda: fm.fused_mlp_int8_prequant_ref(*args,
                                                         add_residual=True))
    route_ms = cuda_ms(lambda: esm2_mlp_route(args))
    ops = 4 * M * d * H
    n_bytes = nbytes(xq, sx, *args[3:]) + nbytes(x)
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_INT8)
    print(f"two-pass int8 mlp M{M} d{d} H{H} G{fm.prequant_group(H)}: "
          f"max_abs_err {errs[0]:.3e} / {errs[1]:.3e} (no residual / "
          f"residual; tol {ATOL} + {RTOL}|plain|, mean {MLP_MEAN_TOL}); two "
          f"launches bitwise equal; hidden codes against the plain stage: "
          f"{codes['gq']} of {codes['gq_of']} differ (by at most "
          f"{codes['gq_max']}); MLP cosine to the W8A8 route {cos:.6f}; MLP "
          f"kernels {ms_pq:.4f} ms (device time: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"), the two passes with the residual {total_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, W8A8 route (several calls) {route_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({ops / 1e12:.2f} T int8 "
          "ops); no single PyTorch call computes it")
    pq = dict(name="fused_mlp_int8_prequant", route="cuda",
              source="procyon_tpu_torch/csrc/fused_ln_mlp_int8.cu",
              replaces="procyon_tpu/ops/fused_mlp.py:255",
              shape=f"M{M} d{d} H{H}", max_abs_err=max(errs), ms=ms_pq,
              two_pass_ms=total_ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=None, route_ms=route_ms,
              cos_route=cos, device_ms=split, codes=codes)
    return rows, pq


def decode_args(dev, M, seed):
    """One Llama-3-8B decode MLP at M rows, the reference probe's scales
    varied per column."""
    import torch
    d, I = DECODE_SHAPE["d"], DECODE_SHAPE["I"]
    g = torch.Generator(device=dev).manual_seed(seed)
    sc = 1.0 / (127.0 * math.sqrt(d))

    def leaf(rows, cols):
        return {"q": torch.randint(-127, 128, (rows, cols), generator=g,
                                   device=dev, dtype=torch.int8),
                "s": torch.rand((1, cols), generator=g, device=dev) * 2 * sc}

    x = torch.randn((M, d), generator=g, device=dev).to(torch.bfloat16)
    nw = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    return x, nw, leaf(d, I), leaf(d, I), leaf(I, d)


def phase_fused_decode(dev):
    """Kernel row 14 at Llama-3-8B width (d 4096, I 14336) at 8 and 16
    rows: against its plain version within DECODE_ATOL + one bf16 ulp,
    bitwise the same on a second launch; the plain version's time and each
    of the two kernels' device time at 16 rows (the down launch overlaps
    gate / up's end: its time counts from its early start)."""
    import torch
    from procyon_tpu_torch.ops import fused_decode as fd
    errs = {}
    for M in DECODE_ROWS:
        args = decode_args(dev, M, SEED + 24 + M)
        out = fd.fused_decode_mlp(*args)
        ref = fd.fused_decode_mlp_ref(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        delta = (ref.float() - args[0].float()).abs().max().item()
        errs[M] = err.max().item()
        check(bool((err <= DECODE_ATOL + RTOL * ref.float().abs()).all()),
              f"fused decode M{M}: max_abs_err {errs[M]}")
        check(torch.equal(out, fd.fused_decode_mlp(*args)),
              f"fused decode M{M}: two launches differ")
        print(f"fused decode mlp M{M} d{DECODE_SHAPE['d']} "
              f"I{DECODE_SHAPE['I']}: max_abs_err {errs[M]:.3e} (tol "
              f"{DECODE_ATOL} + {RTOL}|plain|; the MLP moves the output by "
              f"up to {delta:.3f}), bitwise the same twice")
    plain_ms = cuda_ms(lambda: fd.fused_decode_mlp_ref(*args), iters=3,
                       warmup=1)
    split = device_ms_by_kernel(lambda: fd.fused_decode_mlp(*args),
                                ["decode_gate_up_kernel",
                                 "decode_down_kernel"])
    grid = fd.plan(DECODE_SHAPE["d"], DECODE_SHAPE["I"])
    print(f"fused decode mlp M{M}: plain {plain_ms:.4f} ms; device time "
          f"(weights re-read, 176 MB > L2) gate / up "
          f"{split['decode_gate_up_kernel']:.4f} ms, down "
          f"{split['decode_down_kernel']:.4f} ms; k slices (gate / up, "
          f"down) {grid}")
    return dict(max_abs_err=max(errs.values()), plain_ms=plain_ms,
                gate_up_ms=split["decode_gate_up_kernel"],
                down_ms=split["decode_down_kernel"])


def phase_probes(dev):
    """The two probe entry points at full width, each with its kernels'
    counts zeroed just before and read just after:
    probe_fused_decode at Llama-3-8B (d 4096, I 14336, 32 distinct layers)
    at 16 and 8 rows, probe_fused_mlp_blocks at ESM2-3B (M 32768)."""
    import torch
    from procyon_tpu_torch.ops import fused_decode as fd
    from procyon_tpu_torch.ops import fused_mlp as fm
    from procyon_tpu_torch.scripts import probe_fused_decode as pfd
    from procyon_tpu_torch.scripts import probe_fused_mlp_blocks as pmb
    fd.launches = 0
    decode = {}
    for M in reversed(DECODE_ROWS):
        res = pfd.main(["--dim", str(DECODE_SHAPE["d"]), "--inter",
                        str(DECODE_SHAPE["I"]), "--layers",
                        str(DECODE_SHAPE["layers"]), "--m", str(M)])
        check(res["finite"] and res["kernel_us"] > 0, f"probe_fused_decode "
              f"M{M}: {res}")
        check(res["max_abs_diff"] <= PROBE_CHAIN_RTOL * res["ref_max"],
              f"probe_fused_decode M{M}: the kernel's chain is "
              f"{res['max_abs_diff']} from the int8 route's")
        decode[M] = res
        torch.cuda.empty_cache()
    decode_launches = fd.launches
    fm.launches_ln_quant = fm.launches_prequant = 0
    blocks = pmb.main(["--dim", str(ESM3B_MLP["d"]), "--ffn",
                       str(ESM3B_MLP["H"]), "--rows", str(ESM3B_MLP["M"])])
    check(blocks["finite"], f"probe_fused_mlp_blocks: {blocks}")
    launches = {"fused_decode_mlp": decode_launches,
                "ln_quant_rows": fm.launches_ln_quant,
                "fused_mlp_int8_prequant": fm.launches_prequant}
    torch.cuda.empty_cache()
    return launches, decode, blocks


def paged_lens(B, max_ctx, page, rng):
    """Ragged lengths: a dead slot, one that ends mid-page, one at a page
    boundary, the full context, the rest between a quarter and three
    quarters of it."""
    lens = rng.integers(max_ctx // 4, 3 * max_ctx // 4, B)
    lens[:4] = (0, 4 * page + page // 2 + 12, 5 * page, max_ctx)
    return lens


def paged_pools(dev, g, n, quantized):
    """n (k, v, k_scale, v_scale) pools of the paged shape's widths."""
    import torch
    Hkv, D, page = (PAGED_SHAPE[k] for k in ("Hkv", "D", "page"))
    n_pages = n
    shape = (n_pages, page, Hkv * D)
    if quantized:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand((n_pages, page, Hkv), generator=g, device=dev)
                  * 0.02 + 1e-3 for _ in range(2))
        return k, v, ks, vs
    k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    return k, v, None, None


def paged_inputs(dev, B, quantized):
    """The paged shape's inputs at batch B, 12 pages a slot out of a pool
    of B * 12 + 7: (the generator, q, (k, v, k_scale, v_scale) pools, the
    page table, the lengths in numpy and on the card)."""
    import numpy as np
    import torch
    Hq, D, page, P = (PAGED_SHAPE[k] for k in ("Hq", "D", "page", "P"))
    n_pages = B * P + 7
    g = torch.Generator(device=dev).manual_seed(SEED + 9 + B)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    pool = paged_pools(dev, g, n_pages, quantized)
    table = torch.randperm(n_pages, generator=g, device=dev)[:B * P].reshape(
        B, P).to(torch.int32)
    lens_np = paged_lens(B, P * page, page, np.random.default_rng(SEED + B))
    lens = torch.from_numpy(lens_np).to(dev, torch.int32)
    return g, q, pool, table, lens_np, lens


def paged_cold_pools(dev, g, pool, quantized):
    """pool and copies of it that together exceed the L2 cache."""
    copies = max(2, min(32, math.ceil(2.4 * L2_BYTES / nbytes(*pool))))
    return [pool] + [paged_pools(dev, g, pool[0].shape[0], quantized)
                     for _ in range(copies - 1)]


def paged_kernel_ms(pa, q, pools, table, lens):
    """The paged kernel's device time a call, its pools cold (the copies in
    turn), the host kept ahead. It calls nothing but
    `paged_decode_attention_fullpage`, which every version of the wrapper
    has."""
    Hkv, D = PAGED_SHAPE["Hkv"], PAGED_SHAPE["D"]

    def cold(i):
        kc, vc, ksc, vsc = pools[i % len(pools)]
        return pa.paged_decode_attention_fullpage(
            q, kc, vc, table, lens, n_kv_heads=Hkv, head_dim=D,
            k_scale_pool=ksc, v_scale_pool=vsc)

    return ahead_ms(cold)


def paged_checks(name, out, lse, ref, ref_lse, cut, cut_lse, again, lens):
    """Kernel against the plain version and against its chunked cut (out
    and lse), a dead slot exactly 0 / -1e30, two launches the same bits;
    returns (max_abs_err, lse err)."""
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite")
    check(within_tol(out, ref), f"{name}: max_abs_err {err}")
    check(within_tol(out, cut), f"{name}: the chunked plain version is "
          f"{(out.float() - cut.float()).abs().max().item()} away")
    dead = lens == 0
    check(not out[dead].any().item()
          and bool((lse[dead] == -1e30).all().item()),
          f"{name}: a dead slot is not 0 / -1e30")
    lse_err = max((lse[~dead] - ref_lse[~dead]).abs().max().item(),
                  (lse[~dead] - cut_lse[~dead]).abs().max().item())
    check(lse_err <= LSE_TOL, f"{name}: lse err {lse_err}")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"{name}: two launches differ")
    return err, lse_err


def phase_paged_dead_chunks(dev, quantized):
    """Serving's 16 slots whose lengths (0, 1, one page, the whole table,
    in turn) leave whole chunks of the kernel's page walk dead: against the
    plain version and its chunked cut, twice for the same bits."""
    import torch
    from procyon_tpu_torch.ops import paged_attention as pa
    Hq, Hkv, D, page, P = (PAGED_SHAPE[k] for k in ("Hq", "Hkv", "D", "page",
                                                    "P"))
    B = 16
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = paged_pools(dev, g, B * P + 7, quantized)
    table = torch.randperm(B * P + 7, generator=g, device=dev)[:B * P] \
        .reshape(B, P).to(torch.int32)
    lens = torch.tensor([(0, 1, page, P * page)[i % 4] for i in range(B)],
                        dtype=torch.int32, device=dev)
    kw = dict(n_kv_heads=Hkv, head_dim=D, k_scale_pool=ks, v_scale_pool=vs)
    args = (q, k, v, table, lens)
    out, lse = pa.paged_decode_attention_fullpage(*args, **kw)
    ref, ref_lse = pa.paged_decode_attention_ref(*args, **kw)
    cut, cut_lse = pa.paged_decode_attention_chunked_ref(*args, **kw)
    again = pa.paged_decode_attention_fullpage(*args, **kw)
    torch.cuda.synchronize()
    name = f"paged attention{' int8' if quantized else ''} dead chunks"
    err, lse_err = paged_checks(name, out, lse, ref, ref_lse, cut, cut_lse,
                                again, lens)
    chunks, per = pa.chunk_plan(B, Hkv, P)
    print(f"{name}: B{B}, lengths 0, 1, {page}, {P * page} in turn, "
          f"{chunks} chunks of {per} pages: max_abs_err {err:.3e}, lse err "
          f"{lse_err:.3e}, twice the same bits")


def phase_paged_attention(dev, B, quantized):
    """The paged decode attention at Llama-3-8B widths, 12 pages a slot:
    kernel against plain and against its chunked cut (out and lse), the
    dead slot exactly 0, twice the same bits; times for the kernel (pools
    cold: copies in turn that together exceed the L2 cache, the host kept
    ahead), the plain version, the library call (a gather of the pages,
    then scaled_dot_product_attention under the length mask) and the
    port's own gather route (`_decode_attention_step` over the gathered
    context) at max_ctx 768 and 320."""
    import torch
    import torch.nn.functional as F
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import paged_attention as pa
    Hq, Hkv, D, page, P = (PAGED_SHAPE[k] for k in ("Hq", "Hkv", "D", "page",
                                                    "P"))
    g, q, (k, v, ks, vs), table, lens_np, lens = paged_inputs(dev, B,
                                                              quantized)
    kw = dict(n_kv_heads=Hkv, head_dim=D, k_scale_pool=ks, v_scale_pool=vs)
    name = f"paged attention{' int8' if quantized else ''}"

    def kernel(t=table, n=lens):
        return pa.paged_decode_attention_fullpage(q, k, v, t, n, **kw)

    def plain():
        return pa.paged_decode_attention_ref(q, k, v, table, lens, **kw)

    before = pa.launches
    (out, lse), (ref, ref_lse) = kernel(), plain()
    cut, cut_lse = pa.paged_decode_attention_chunked_ref(q, k, v, table,
                                                         lens, **kw)
    again = kernel()
    torch.cuda.synchronize()
    check(pa.launches == before + 2, f"{name}: the wrapper did not launch")
    err, lse_err = paged_checks(name, out, lse, ref, ref_lse, cut, cut_lse,
                                again, lens)
    dead = lens == 0
    pools = paged_cold_pools(dev, g, (k, v, ks, vs), quantized)
    copies = len(pools)
    ms = paged_kernel_ms(pa, q, pools, table, lens)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)

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
    chunks, per = pa.chunk_plan(B, Hkv, P)

    library_ms = None
    if not quantized:
        tab_l = table.long()
        S = P * page
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        mask = mask | dead[:, None, None, None]   # a dead row must not NaN
        qt = q[:, :, None, :]                      # [B, Hq, 1, D]

        def library(i=0):
            kp, vp = pools[i % copies][:2]
            kc = kp[tab_l].reshape(B, S, Hkv, D).transpose(1, 2)
            vc = vp[tab_l].reshape(B, S, Hkv, D).transpose(1, 2)
            return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)

        lib = library()[:, :, 0]
        diff = (lib[~dead].float() - out[~dead].float()).abs().max().item()
        check(diff <= LIBRARY_ATOL, f"{name}: gather + sdpa is {diff} from "
                                    "the kernel on live slots")
        library_ms = ahead_ms(library, iters=10)
    del pools

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
          f"({live_tokens} live tokens; {chunks} chunks of {per} pages): "
          f"max_abs_err {err:.3e}, lse err {lse_err:.3e} (tol {ATOL} + "
          f"{RTOL}|plain|, lse {LSE_TOL}), twice the same bits; kernel "
          f"{ms:.4f} ms (pools cold, {copies} copies in turn), plain "
          f"{plain_ms:.4f} ms, gather + sdpa {lib_s}, bound {bound_ms:.4f} "
          f"ms by {bound_by} ({n_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
          f"GFLOP; {bound_ms / ms:.2f} of the bound); the port's gather "
          f"route {r768:.4f} ms against the kernel's {k768:.4f} at max_ctx "
          f"768, {r320:.4f} against {k320:.4f} at max_ctx 320")
    return dict(name="paged_attention", route="cuda",
                source="procyon_tpu_torch/csrc/paged_attention.cu",
                replaces="procyon_tpu/ops/paged_attention.py:250",
                shape=shape_s, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                chunks=chunks, live_tokens=live_tokens,
                gather_route_ms_ctx768=r768, gather_route_ms_ctx320=r320,
                kernel_ms_ctx320=k320)


def phase_paged(dev):
    """The paged decode attention at every batch of PAGED_BATCHES, bf16 and
    int8 pools, and the dead-chunk case. The entry of the JSON line is B80
    in bf16 (one caption beam step); the other batches ride beside it."""
    by_batch = {}
    for quantized in (False, True):
        for b in PAGED_BATCHES:
            by_batch[(b, quantized)] = phase_paged_attention(dev, b,
                                                             quantized)
        phase_paged_dead_chunks(dev, quantized)
    entry = dict(by_batch[(PAGED_BATCHES[-1], False)])
    entry["batches"] = {
        f"B{b}{' int8' if q else ''}": {k: r[k] for k in (
            "ms", "bound_ms", "library_ms", "plain_ms", "chunks",
            "live_tokens", "max_abs_err")}
        for (b, q), r in by_batch.items()}
    return entry


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
    cap_metrics = caption_metrics(captions, store)

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
        prompt_tokens=lens.tolist(), caption_metrics=cap_metrics)


def ahead_ms(fn, iters=20, warmup=3):
    """CUDA-event time of `fn(i)` per call with the host kept ahead of the
    device: a spin kernel is queued first, so the calls' launches pile up
    behind it and the events bracket device work alone. For kernels that
    take less time than their wrapper's Python."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)          # some 20 ms of device time
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def int4_case(dev, name, k, n, rows, g):
    """One shape of the int4 matmul: kernel against plain, twice for the
    same bits, one device kernel a call, then times over copies of the
    weight that together exceed the L2 cache."""
    import torch
    from procyon_tpu_torch.ops import int4_matmul as im
    from procyon_tpu_torch.ops import quant
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    qw = quant.quantize4(w, group=INT4_GROUP)
    x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
    before = im.launches
    out = im.qmatvec4(x, qw)
    ref = im.qmatvec4_ref(x, qw)
    torch.cuda.synchronize()
    check(im.launches == before + 1, f"int4 {name}: the wrapper did not "
                                     "launch")
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), f"int4 {name}: "
                                                    "non-finite")
    check(within_tol(out, ref), f"int4 {name} rows {rows}: max_abs_err {err}")
    check(torch.equal(out, im.qmatvec4(x, qw)), f"int4 {name}: two launches "
                                                "differ")
    check(torch.equal(quant.mm(x, qw), out), f"int4 {name}: quant.mm took "
                                             "another route")
    n_kernels, kernel_names = kernels_a_call(lambda: im.qmatvec4(x, qw))
    check(n_kernels == 1, f"int4 {name} rows {rows}: {n_kernels} device "
                          f"kernels a call ({kernel_names}), not 1")
    wb = w.to(torch.bfloat16)
    del w
    deq = x @ quant.dequantize4(qw, torch.bfloat16)
    scale = deq.float().abs().max().item()
    deq_err = (out.float() - deq.float()).abs().max().item()
    check(deq_err <= INT4_DEQUANT_RTOL * scale,
          f"int4 {name}: {deq_err} from the dequantize route (largest "
          f"output {scale})")
    n_bytes = nbytes(qw["p"], qw["s"], x, out)
    qws = int4_cold_weights(qw)
    copies = len(qws)
    ms = int4_kernel_ms(im, x, qws)
    plain_ms = cuda_ms(lambda: im.qmatvec4_ref(x, qw), iters=3, warmup=1)
    library_ms = ahead_ms(
        lambda i: x @ quant.dequantize4(qws[i % copies], torch.bfloat16),
        iters=10)
    n_bf16 = max(2, min(copies, math.ceil(2.4 * L2_BYTES / nbytes(wb))))
    wbs = [wb] + [wb.clone() for _ in range(n_bf16 - 1)]
    bf16_ms = ahead_ms(lambda i: x @ wbs[i % n_bf16])
    ops = 2 * rows * k * n
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_BF16)
    grid = im.plan(rows, n, k // 2 // INT4_GROUP)
    print(f"int4 matmul {name} k{k} n{n} rows {rows} (group {INT4_GROUP}; "
          f"row tile {grid[0]}, column tile {grid[1]}, {grid[2]} k slices "
          f"a cluster; {n_kernels:g} device kernel a call): max_abs_err "
          f"{err:.3e} (tol {ATOL} + {RTOL}|plain|), {deq_err:.3e} from "
          f"dequantize4 + matmul; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, dequantize4 + matmul {library_ms:.4f} ms, bf16 x @ w "
          f"{bf16_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({n_bytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; "
          f"{bound_ms / ms:.2f} of the bound; {copies} weight copies in "
          "turn)")
    return dict(shape=f"{name} k{k} n{n} rows {rows}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bf16_matmul_ms=bf16_ms,
                grid=list(grid), kernels_a_call=n_kernels)


def int4_cold_weights(qw):
    """qw and copies of it that together exceed the L2 cache, so that
    calls in turn read their weights from device memory."""
    n_bytes = nbytes(qw["p"], qw["s"])
    copies = max(2, min(64, math.ceil(2.4 * L2_BYTES / n_bytes)))
    return [qw] + [{"p": qw["p"].clone(), "s": qw["s"].clone()}
                   for _ in range(copies - 1)]


def int4_kernel_ms(im, x, qws):
    """The int4 kernel's device time a call, its weights cold (the copies
    in turn), the host kept ahead. It calls nothing but `qmatvec4`, which
    every version of the wrapper has."""
    return ahead_ms(lambda i: im.qmatvec4(x, qws[i % len(qws)]))


def host_us_a_call(fn, calls=200):
    """The host's time a call of fn, with `calls` calls queued behind a
    spin kernel, so that no call waits for the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def int4_host_us(dev, g):
    """What a decode round feels that one launch's device time does not
    show: the wrapper's host time a call beside `x @ w`'s (an eager
    forward makes 225 such calls and is bound by the host)."""
    import torch
    from procyon_tpu_torch.ops import int4_matmul as im
    from procyon_tpu_torch.ops import quant
    w = torch.randn((4096, 4096), generator=g, device=dev) / 64
    qw, wb = quant.quantize4(w, group=INT4_GROUP), w.to(torch.bfloat16)
    x = torch.randn((INT4_ROWS, 4096), generator=g, device=dev).to(
        torch.bfloat16)
    host_us = {name: host_us_a_call(fn) for name, fn in (
        ("qmatvec4", lambda: im.qmatvec4(x, qw)),
        ("quant.mm on an int4 leaf", lambda: quant.mm(x, qw)),
        ("bf16 x @ w", lambda: x @ wb))}
    print("int4 matmul, host time a call (200 calls queued behind a spin "
          "kernel): " + ", ".join(f"{k} {v:.1f} us"
                                  for k, v in host_us.items()))
    return host_us


def row_and_move_times(dev):
    """Rows 5, 11 and 12 timed as phase_prequant_mlp and phase_staged_move
    time them, inputs cold (three copies of x in turn: 168 MB each at
    d 2560; the moves' 420 MB over a 3.44 GiB pool) and the host kept
    ahead, through no call but `ln_quant_rows`, `move_pages` and
    `move_pages_direct`, which the first versions had as well; each beside
    its bytes' share of the card's copy rate and of the published memory
    rate. Row 5 at ESM2-3B's d 2560 and at row 4's d 1280 (ESM2-650M),
    32768 rows; row 11 at path g's plan (staged_moves), row 12 at one beam
    step's (direct_moves), both on the caption pool in bf16."""
    import torch
    from procyon_tpu_torch.ops import fused_mlp as fm
    from procyon_tpu_torch.ops import page_move as pm
    out = {}
    M = ESM3B_MLP["M"]
    for d in (ESM3B_MLP["d"], MLP_SHAPE["d"]):
        g = torch.Generator(device=dev).manual_seed(SEED + 50 + d)
        xs = [torch.randn((M, d), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(3)]
        lnw = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        lnb = 0.1 * torch.randn(d, generator=g, device=dev)
        ms = ahead_ms(lambda i: fm.ln_quant_rows(xs[i % 3], lnw, lnb))
        out[f"ln_quant_rows M{M} d{d}"] = dict(
            ms=ms, **rate_shares(3 * M * d + 4 * (M + 2 * d), ms, dev))
        del xs
    L, n_pages, page, KD = (POOL_SHAPE[k] for k in ("L", "n_pages", "page",
                                                    "KD"))
    N, M = L * n_pages, PAGE_MOVES
    pool = torch.zeros((N, page, KD), dtype=torch.bfloat16, device=dev)
    row_bytes = page * KD * 2
    for name, plan, fn in (
            ("move_pages (row 11, path g)", staged_moves, pm.move_pages),
            ("move_pages_direct (row 12, a beam step)", direct_moves,
             pm.move_pages_direct)):
        src, dst = plan(dev, N, M, torch.Generator(device=dev).manual_seed(
            SEED + 22 if fn is pm.move_pages else SEED + 8))
        n_bytes = (src.unique().numel() + M) * row_bytes + nbytes(src, dst)
        ms = ahead_ms(lambda i: fn(pool, src, dst))
        out[name] = dict(ms=ms, **rate_shares(n_bytes, ms, dev))
    del pool
    torch.cuda.empty_cache()
    print("times, inputs cold, host kept ahead: " + "; ".join(
        f"{k} {v['ms']:.4f} ms ({v['copy_share']:.1%} of the copy rate, "
        f"{v['peak_share']:.1%} of {PEAK_BYTES / 1e12:.2f} TB/s)"
        for k, v in out.items()))
    return out


def phase_times(dev):
    """Rows 5, 11 and 12 (row_and_move_times), rows 13 and 10 by the
    yardsticks phase_int4 and phase_paged_attention time them with
    (weights and pools cold, the host kept ahead), the wrappers' host time
    a call, and rows 7 and 14 (mlp_times), through no call but
    `ln_quant_rows`, `move_pages`, `move_pages_direct`, `qmatvec4`,
    `paged_decode_attention_fullpage`, `fused_rms_swiglu_int8` and
    `fused_decode_mlp`, which the first versions had as well: this
    script, copied into a checkout of an earlier commit and run there
    with --only=times, times that commit's kernels the same way."""
    import torch
    rows_moves = row_and_move_times(dev)
    from procyon_tpu_torch.ops import int4_matmul as im
    from procyon_tpu_torch.ops import paged_attention as pa
    from procyon_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    wide = INT4_SHAPES[2]
    cases = [(name, k, n, INT4_ROWS, c) for name, k, n, c in INT4_SHAPES] \
        + [(*wide[:3], rows, 0) for rows in INT4_MORE_ROWS]
    int4, forward = {}, 0.0
    for name, k, n, rows, per_forward in cases:
        qw = quant.quantize4(torch.randn((k, n), generator=g, device=dev)
                             * k ** -0.5, group=INT4_GROUP)
        x = torch.randn((rows, k), generator=g, device=dev).to(
            torch.bfloat16)
        int4[f"{name} rows {rows}"] = ms = int4_kernel_ms(
            im, x, int4_cold_weights(qw))
        forward += per_forward * ms
        del qw
        torch.cuda.empty_cache()
    int4_host = int4_host_us(dev, g)
    paged, paged_host = {}, None
    Hkv, D = PAGED_SHAPE["Hkv"], PAGED_SHAPE["D"]
    for quantized in (False, True):
        for B in PAGED_BATCHES:
            gp, q, pool, table, _, lens = paged_inputs(dev, B, quantized)
            pools = paged_cold_pools(dev, gp, pool, quantized)
            paged[f"B{B}{' int8' if quantized else ''}"] = paged_kernel_ms(
                pa, q, pools, table, lens)
            if B == SERVING["slots"] and not quantized:
                paged_host = host_us_a_call(
                    lambda: pa.paged_decode_attention_fullpage(
                        q, *pool[:2], table, lens, n_kv_heads=Hkv,
                        head_dim=D))
            del pools
            torch.cuda.empty_cache()
    print("times, weights and pools cold, host kept ahead: int4 "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in int4.items())
          + f"; a {INT4_ROWS}-row forward's launches {forward:.3f} ms; "
          "paged " + ", ".join(f"{k} {v:.4f} ms" for k, v in paged.items())
          + f"; paged host time a call at B{SERVING['slots']} "
          f"{paged_host:.1f} us")
    mlps = mlp_times(dev)
    return dict(rows_moves_ms=rows_moves, int4_ms=int4,
                int4_forward_ms=forward, int4_host_us=int4_host,
                paged_ms=paged, paged_host_us=paged_host, **mlps)


def mlp_times(dev):
    """Rows 7 and 14 timed as phase_times times rows 13 and 10, through no
    call but `fused_rms_swiglu_int8` and `fused_decode_mlp`: row 7 at both
    SWIGLU_SHAPES on the weight layout its wrapper reads without a copy
    (135 / 176 MB of weights, more than the L2 holds), row 14 at each of
    DECODE_ROWS over DECODE_COLD distinct layers in turn; each with the
    device time of every kernel a call runs."""
    import torch
    from procyon_tpu_torch.ops import fused_decode as fd
    from procyon_tpu_torch.ops import fused_mlp as fm
    swiglu, decode = {}, {}
    layout = swiglu_layout(fm)
    for i, (M, d, H) in enumerate(SWIGLU_SHAPES):
        args = swiglu_args(dev, M, d, H, SEED + 40 + i, layout)

        def call(_=0):
            return fm.fused_rms_swiglu_int8(*args)

        swiglu[f"M{M} d{d} H{H}"] = dict(ms=ahead_ms(call, iters=10),
                                         split=device_ms_all(call))
        del args
        torch.cuda.empty_cache()
    for M in DECODE_ROWS:
        layers = [decode_args(dev, M, SEED + 24 + M + i)
                  for i in range(DECODE_COLD)]
        x, nw = layers[0][:2]
        turn = [0]

        def call(i=None):
            if i is None:
                i = turn[0] = turn[0] + 1
            return fd.fused_decode_mlp(x, nw, *layers[i % DECODE_COLD][2:])

        decode[f"M{M}"] = dict(ms=ahead_ms(call, iters=32),
                               split=device_ms_all(call, reps=8))
        del layers
        torch.cuda.empty_cache()
    print(f"times, weights cold, host kept ahead ({swiglu_layout(fm)} "
          "weights for row 7): fused_rms_swiglu_int8 "
          + "; ".join(f"{k} {v['ms']:.4f} ms (" + ", ".join(
              f"{n} {t:.4f}" for n, t in v["split"].items()) + ")"
              for k, v in swiglu.items())
          + "; fused_decode_mlp "
          + "; ".join(f"{k} {v['ms']:.4f} ms (" + ", ".join(
              f"{n} {t:.4f}" for n, t in v["split"].items()) + ")"
              for k, v in decode.items()))
    return dict(swiglu_ms=swiglu, decode_ms=decode)


def phase_int4(dev):
    """The int4 unpack + matmul kernel at the five Llama-3-8B weight shapes
    at a decode round's 16 rows, and at 128 and 256 rows on w_gate. The
    entry of the JSON line is the w_gate / w_up shape (the largest of a
    layer); the other shapes and the sum over one forward ride beside it."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    per_shape, forward = [], dict(ms=0.0, bound_ms=0.0, library_ms=0.0,
                                  bf16_matmul_ms=0.0)
    kernels = 0.0
    for name, k, n, per_forward in INT4_SHAPES:
        r = int4_case(dev, name, k, n, INT4_ROWS, g)
        per_shape.append(r)
        for key in forward:
            forward[key] += per_forward * r[key]
        kernels += per_forward * r["kernels_a_call"]
        torch.cuda.empty_cache()
    for rows in INT4_MORE_ROWS:
        name, k, n, _ = INT4_SHAPES[2]
        per_shape.append(int4_case(dev, name, k, n, rows, g))
        torch.cuda.empty_cache()
    host_us = int4_host_us(dev, g)
    n_calls = sum(c for *_, c in INT4_SHAPES)
    print(f"int4 matmul, one forward of {INT4_ROWS} rows at Llama-3-8B "
          f"({n_calls} calls, {kernels:g} device kernels): kernel "
          f"{forward['ms']:.3f} ms, bound {forward['bound_ms']:.3f} ms, "
          f"dequantize4 + matmul {forward['library_ms']:.3f} ms, bf16 x @ w "
          f"{forward['bf16_matmul_ms']:.3f} ms (sums of the shapes' times)")
    main = per_shape[2]
    return dict(name="int4_matmul", route="cuda",
                source="procyon_tpu_torch/csrc/int4_matmul.cu",
                replaces="procyon_tpu/ops/int4_matmul.py:146",
                **{k: main[k] for k in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                per_shape=per_shape,
                forward_16_rows={k: round(v, 4) for k, v in forward.items()},
                device_kernels_a_forward=kernels, host_us_a_call=host_us)


class ForwardLog:
    """Counts the forwards a batcher runs, by patching the name
    `llama.paged_forward` that inference/serving.py calls: rows of the
    layers' matmuls, rows of the head's, and the block width."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from procyon_tpu_torch.inference import serving
        self._llama = serving.llama
        forward = serving.llama.paged_forward

        def counting(*a, tokens=None, input_embeds=None, logits_at=None,
                     **kw):
            x = tokens if tokens is not None else input_embeds
            B, T = x.shape[0], x.shape[1]
            self.calls.append((B * T, B if logits_at is not None else B * T,
                               T))
            return forward(*a, tokens=tokens, input_embeds=input_embeds,
                           logits_at=logits_at, **kw)

        self._patch = patched(serving.llama, "paged_forward", counting)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)

    def int4_launches(self, n_layers):
        """7 matmuls a layer and the head, each through the kernel when its
        rows are at most 256."""
        return sum(7 * n_layers * (rows <= 256) + (head <= 256)
                   for rows, head, _ in self.calls)

    def decode_steps(self):
        return sum(T == 1 for *_, T in self.calls)


def serving_args(**over):
    """scripts/bench_serving.py's flags for SERVING's traffic (its default
    traffic with the protein-serving options: a shared instruction prefix,
    the prefix cache) on the card, with `over` replacing entries."""
    from procyon_tpu_torch.scripts import bench_serving
    args = bench_serving.parse_args([])
    vars(args).update(SERVING, device="cuda", seed=SEED, prefix_cache=True)
    vars(args).update(over)
    return args


def phase_serving_small(dev):
    """Continuous batching on the card (bf16; int4 weights through the
    kernel; decode steps through the page-walk kernel; prompts of more than
    16 tokens through the flash kernel) against the same batcher on the CPU
    in f32 on the same int4 weights. Random weights put near ties among
    8192 logits, and one flipped token departs for good, so the card is
    stepped under the CPU's tokens: every sampled row's logits are held to
    SERVING_LOGIT_ATOL, and the emitted tokens are then the CPU's. The
    card's own run is printed beside it. Then the int4 logits by the
    kernel route against the dequantize route on the card."""
    import numpy as np
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.inference import kv_pool, serving
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import (flash_attention, int4_matmul,
                                       paged_attention, quant)
    from procyon_tpu_torch.scripts import bench_serving
    c = SERVING_SMALL
    cfg = llama.LlamaConfig(
        vocab_size=c["vocab"], dim=c["dim"], n_layers=c["layers"],
        n_heads=c["heads"], n_kv_heads=c["kv_heads"],
        intermediate=c["intermediate"], rope_theta=500000.0,
        max_seq_len=1024, dtype=torch.bfloat16)
    params = llama.quantize_params(
        llama.init_params(SEED + 31, cfg, device=dev), cfg, bits=4,
        group=INT4_GROUP)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = bridge.to_torch(bridge.to_numpy(params), device="cpu")
    check(quant.is_quantized4(params["layers"]["mlp"]["w_down"])
          and quant.is_quantized4(params["lm_head"])
          and p32["lm_head"]["p"].dtype == torch.int8,
          "the small check's weights are not int4")

    def pcfg(dtype):
        return kv_pool.PagedConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, page_size=64, n_pages=64,
            max_pages_per_seq=8, slots=c["slots"], dtype=dtype)

    rng = np.random.default_rng(SEED + 31)
    prefix = list(map(int, rng.integers(4, cfg.vocab_size, 130)))
    reqs = [("tok", prefix + list(map(int, rng.integers(
        4, cfg.vocab_size, n)))) for n in (20, 75, 9)]
    reqs += [("tok", list(map(int, rng.integers(4, cfg.vocab_size, n))))
             for n in (12, 40)]
    reqs.append(("fused", rng.standard_normal((50, cfg.dim)).astype(
        np.float32) * 0.02))
    kw = dict(step_quantum=c["quantum"], prefix_cache=True)
    # bench_serving's workload form, every request arriving at once
    workload = [(0, kind, len(p), p, c["new_tokens"]) for kind, p in reqs]

    def serve(b):
        """The requests' tokens, in order, through bench_serving.drive."""
        bench_serving.drive(b, workload)
        return [b.done[r] for r in range(len(workload))]

    def sampled_rows(b, logits):
        # a decode round samples every slot: only the live ones mean
        # anything; a prefill samples its one row
        return sorted(b.live) if logits.shape[0] == c["slots"] else [0]

    log = []
    cpu = serving.ContinuousBatcher(p32, cfg32, pcfg(torch.float32),
                                    device="cpu", **kw)
    cpu_sample = cpu._sample

    def recording(logits):
        toks = cpu_sample(logits)
        log.append((logits[sampled_rows(cpu, logits)].clone(), toks.clone()))
        return toks

    cpu._sample = recording
    t0 = time.perf_counter()
    want = serve(cpu)
    cpu_s = time.perf_counter() - t0

    errs = []
    card = serving.ContinuousBatcher(params, cfg, pcfg(torch.bfloat16), **kw)

    def replay(logits):
        ref_logits, ref_toks = log[len(errs)]
        rows = sampled_rows(card, logits)
        check(ref_toks.shape[0] == logits.shape[0]
              and ref_logits.shape[0] == len(rows),
              f"serving check: sample {len(errs)} has another shape on the "
              "card")
        got = logits[rows].float().cpu()
        check(torch.isfinite(got).all().item(), "serving check: non-finite "
                                                "logits")
        errs.append((got - ref_logits).abs().max().item())
        return ref_toks.to(dev)

    card._sample = replay
    int4_matmul.launches = paged_attention.launches = 0
    flash_attention.launches = 0
    with ForwardLog() as flog:
        got = serve(card)
    torch.cuda.synchronize()
    check(len(errs) == len(log), f"the card sampled {len(errs)} times, the "
                                 f"CPU {len(log)}")
    check(got == want, "under the CPU's tokens the card emitted others")
    check(card.waste == cpu.waste
          and card.pcache.stats == cpu.pcache.stats
          and card.pcache.stats["hit_tokens"] > 0,
          f"serving check: waste {card.waste} / {cpu.waste}, prefix cache "
          f"{card.pcache.stats} / {cpu.pcache.stats}")
    n_int4, n_walk = int4_matmul.launches, paged_attention.launches
    check(n_int4 == flog.int4_launches(cfg.n_layers) and n_int4 > 0,
          f"serving check: {n_int4} int4 launches, expected "
          f"{flog.int4_launches(cfg.n_layers)}")
    check(n_walk == cfg.n_layers * flog.decode_steps() and n_walk > 0,
          f"serving check: {n_walk} paged attention launches for "
          f"{flog.decode_steps()} decode steps")
    check(flash_attention.launches > 0, "serving check: no prefill took the "
                                        "flash kernel")
    check(max(errs) <= SERVING_LOGIT_ATOL,
          f"serving check: logits {max(errs)} from the CPU's")

    own = serve(serving.ContinuousBatcher(params, cfg, pcfg(torch.bfloat16),
                                          **kw))
    agree = sum(a == b for o, w_ in zip(own, want) for a, b in zip(o, w_)) \
        / sum(len(w_) for w_ in want)

    # the two int4 routes on the card: the kernel, and dequantize + matmul
    pool = kv_pool.init_pool(pcfg(torch.bfloat16), device=dev)
    pool["page_table"][0, :2] = torch.tensor([1, 2], dtype=torch.int32,
                                             device=dev)
    tokens = torch.from_numpy(rng.integers(4, cfg.vocab_size, (1, 40))).to(dev)
    slot = torch.zeros((1,), dtype=torch.long, device=dev)
    routes = []
    for kernel_route in (True, False):
        for t in pool.values():
            if t is not pool["page_table"]:
                t.zero_()
        before = int4_matmul.launches
        with contextlib.ExitStack() as stack:
            if not kernel_route:
                stack.enter_context(patched(quant, "takes_kernel4",
                                            lambda rows, qw: False))
            pre, _ = llama.paged_forward(params, cfg, pool, pcfg(
                torch.bfloat16), slot, tokens=tokens, max_position=39)
            dec, _ = llama.paged_forward(params, cfg, pool, pcfg(
                torch.bfloat16), slot, tokens=tokens[:, :1], max_position=40)
        check((int4_matmul.launches > before) == kernel_route,
              "the int4 route was not the one asked for")
        routes.append(torch.cat([pre[0], dec[0]]))
    route_err = (routes[0] - routes[1]).abs().max().item()
    check(route_err <= SERVING_LOGIT_ATOL,
          f"int4 kernel route is {route_err} from the dequantize route")
    print(f"serving check (int4 weights, {c['layers']} layers, dim "
          f"{c['dim']}, vocab {c['vocab']}; {len(reqs)} requests, "
          f"{c['new_tokens']} new tokens, {c['quantum']}-step rounds, "
          f"prefix cache): card bf16 against CPU f32 (CPU run {cpu_s:.1f} "
          f"s), stepped under the CPU's tokens: logits of {len(errs)} "
          f"sampled blocks within {max(errs):.4f} (asserted <= "
          f"{SERVING_LOGIT_ATOL}), tokens, waste and prefix-cache counters "
          f"equal; {n_int4} int4 launches = 7 x {cfg.n_layers} + 1 for each "
          f"of {len(flog.calls)} forwards, {n_walk} paged attention "
          f"launches = {cfg.n_layers} x {flog.decode_steps()} decode steps, "
          f"{flash_attention.launches} flash launches; left to its own "
          f"tokens the card agrees on {agree:.3f} of them; int4 kernel "
          f"route against dequantize4 + matmul on the card: logits within "
          f"{route_err:.4f}")


def profile_round(batcher, what, untraced_ms, warm=2):
    """torch.profiler over one decode round of `batcher` (its slots all
    live) after `warm` untraced rounds: wall, device-busy time and kernels
    of the round, the device's idle share of the untraced round
    (`untraced_ms`, from the run above), and the kernels that take most of
    the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    k = batcher.step_quantum

    def run(n):
        for _ in range(n):
            batcher._round(k)
        torch.cuda.synchronize()

    run(warm)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(1)                          # pays the tracer's start
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(1)
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    print(f"one {k}-step decode round ({what}, {len(batcher.live)} live "
          f"slots) under torch.profiler: wall {wall:.1f} ms (tracing on), "
          f"device busy {busy:.1f} ms in {count} kernels, {count / k:.0f} a "
          f"step; of the untraced {untraced_ms:.1f} ms per round the device "
          f"idles {1 - busy / untraced_ms:.2f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3 / k:8.3f} ms a step in "
              f"{e.count / k:6.0f} launches  {e.key[:90]}")


def phase_serving(dev, service, profile=False):
    """The slice's main path: continuous-batching serving at Llama-3-8B
    width on the /retrieve phase's decoder through scripts/bench_serving.py
    (its workload, pool, batcher, drive loop and JSON line), with bf16
    weights, with int4 weights, and in bf16 with async rounds; rows 3, 10
    and 13 held against their plain versions at every shape the runs
    launched them at. Returns (launches of the int4 and the paged
    attention kernel, results)."""
    import numpy as np
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import (flash_attention, int4_matmul,
                                       paged_attention)
    from procyon_tpu_torch.scripts import bench_serving
    w = SERVING
    lcfg = service.cfg.llama
    params = service.params["llama"]
    args = serving_args()
    pcfg = bench_serving.pool_config(args, lcfg)
    check((pcfg.n_pages, pcfg.max_ctx) == (128, 640),
          f"the serving pool changed: {pcfg}")
    t0 = time.perf_counter()
    params4 = llama.quantize_params(params, lcfg, bits=4, group=INT4_GROUP)
    torch.cuda.synchronize()
    bytes4, bytes16 = (sum(t.numel() * t.element_size()
                           for t in bridge.tree_leaves(p))
                       for p in (params4, params))
    print(f"serving: Llama-3-8B ({lcfg.n_layers} layers, dim {lcfg.dim}, "
          f"vocab {lcfg.vocab_size}); {w['slots']} slots, {w['requests']} "
          f"requests (token / fused alternating, a shared "
          f"{w['shared_prefix']}-token prefix + {w['min_prompt']}-"
          f"{w['max_prompt']}, {w['max_new']} new tokens), "
          f"{w['step_quantum']}-step rounds, arrivals over "
          f"{w['arrival_rounds']} rounds, pool {pcfg.n_pages} pages of "
          f"{w['page_size']} x {lcfg.n_layers} layers, max_ctx "
          f"{pcfg.max_ctx}; weights {bytes16 / 1e9:.2f} GB bf16, "
          f"{bytes4 / 1e9:.2f} GB int4 (quantized in "
          f"{time.perf_counter() - t0:.1f} s)")
    workload = bench_serving.make_workload(args, lcfg,
                                           np.random.default_rng(SEED))
    warm = bench_serving.make_workload(
        serving_args(requests=4, max_new=9, arrival_rounds=1), lcfg,
        np.random.default_rng(SEED + 1))
    n_params = bench_serving.count_params(params)
    results, launches, batchers, tokens = {}, {}, {}, {}
    shapes = LaunchShapes()
    # bf16 and int4 run twice, in turns: the host's speed drifts within a
    # call, and a round is bound by the host
    for name, tree, async_rounds in (("bf16", params, False),
                                     ("int4", params4, False),
                                     ("bf16 async", params, True),
                                     ("int4, again", params4, False),
                                     ("bf16, again", params, False)):
        b = batchers.get(name.split(",")[0])
        if b is None:
            b = bench_serving.make_batcher(
                tree, lcfg, pcfg, serving_args(async_rounds=async_rounds))
            bench_serving.drive(b, warm)      # first calls of every route
        torch.cuda.reset_peak_memory_stats()
        int4_matmul.launches = paged_attention.launches = 0
        flash_attention.launches = 0
        with ForwardLog() as flog, shapes:
            res = bench_serving.run(
                tree, lcfg, serving_args(async_rounds=async_rounds),
                n_params=n_params, batcher=b, workload=workload, warm=False)
        d = res["drive"]
        lat, util, wall = d["lat"], d["util"], d["wall"]
        round_s, n_rounds = d["round_s"], d["n_rounds"]
        n_int4, n_walk = int4_matmul.launches, paged_attention.launches
        n_flash = flash_attention.launches
        done = b.done
        n_tokens = sum(len(v) for v in done.values())
        check(len(done) == w["requests"]
              and all(len(v) == w["max_new"] for v in done.values()),
              f"serving ({name}): {len(done)} requests finished with "
              f"{sorted({len(v) for v in done.values()})} tokens")
        steps = flog.decode_steps()
        check(n_walk == lcfg.n_layers * steps,
              f"serving ({name}): {n_walk} paged attention launches for "
              f"{steps} decode steps")
        want4 = flog.int4_launches(lcfg.n_layers) if tree is params4 else 0
        check(n_int4 == want4 and (n_int4 > 0) == (tree is params4),
              f"serving ({name}): {n_int4} int4 launches, expected {want4}")
        check(b.pcache.stats["hit_tokens"] > 0, f"serving ({name}): the "
                                                "prefix cache never hit")
        long_prefills = sum(rows > 256 for rows, *_ in flog.calls)
        prefills = sum(T > 1 for *_, T in flog.calls)
        r = dict(requests_per_sec=w["requests"] / wall,
                 output_tokens_per_sec=n_tokens / wall,
                 latency_p50_s=float(np.percentile(lat, 50)),
                 latency_p95_s=float(np.percentile(lat, 95)),
                 slot_utilisation=float(util.mean()),
                 ms_per_round=round_s / n_rounds * 1e3, rounds=n_rounds,
                 wall_s=wall, waste=dict(b.waste),
                 prefix_hit_tokens=b.pcache.stats["hit_tokens"],
                 peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 int4_launches=n_int4, paged_attention_launches=n_walk,
                 flash_launches=n_flash, decode_steps=steps)
        results[name] = r
        launches[name] = (n_int4, n_walk)
        batchers[name.split(",")[0]] = b
        tokens[name] = dict(done)
        print(f"  {name}: {w['requests']}/{w['requests']} requests, "
              f"{n_tokens} tokens in {wall:.2f} s: "
              f"{r['requests_per_sec']:.3f} requests/s, "
              f"{r['output_tokens_per_sec']:.1f} output tokens/s, latency "
              f"p50 {r['latency_p50_s']:.2f} s p95 "
              f"{r['latency_p95_s']:.2f} s, slot utilisation "
              f"{r['slot_utilisation']:.3f}, {r['ms_per_round']:.1f} ms per "
              f"{w['step_quantum']}-step round over {n_rounds} rounds "
              f"(ticks less their admissions), waste {b.waste}, prefix "
              f"cache hit {b.pcache.stats['hit_tokens']} tokens / missed "
              f"{b.pcache.stats['miss_tokens']}, peak device memory "
              f"{r['peak_device_gib']:.2f} GiB")
        print(f"    bench_serving: {json.dumps(res['line'])}")
        print(f"    launches: paged attention {n_walk} = {lcfg.n_layers} x "
              f"{steps} decode steps; flash {n_flash} over {prefills} "
              f"prefill forwards; int4 matmul {n_int4}"
              + (f" = (7 x {lcfg.n_layers} + 1) x "
                 f"{len(flog.calls) - long_prefills} forwards of at most "
                 f"256 rows + 1 (the head's row) x {long_prefills} longer "
                 "prefills, whose layers dequantize"
                 if tree is params4 else ""))
    for a, b_ in (("bf16", "bf16 async"), ("bf16", "bf16, again"),
                  ("int4", "int4, again")):
        check(tokens[a] == tokens[b_], f"serving: the {b_} run's tokens "
                                       f"differ from the {a} run's")
    ms = {k: v["ms_per_round"] for k, v in results.items()}
    print(f"  async rounds emit the synchronous tokens for all "
          f"{w['requests']} requests, and both repeats their first run's; "
          f"ms per round in the order run: bf16 {ms['bf16']:.1f}, int4 "
          f"{ms['int4']:.1f}, bf16 async {ms['bf16 async']:.1f}, int4 "
          f"{ms['int4, again']:.1f}, bf16 {ms['bf16, again']:.1f}")
    if profile:
        for name in ("bf16", "int4"):
            b = batchers[name]
            b.reset()
            for _, kind, _, payload, _ in workload[:w["slots"]]:
                b.submit(payload, max_new=w["max_new"]) if kind == "tok" \
                    else b.submit_fused(payload, max_new=w["max_new"])
            b._admit()
            profile_round(b, f"{name} weights",
                          results[name]["ms_per_round"])
            b.reset()
    del batchers, params4
    torch.cuda.empty_cache()
    results["held_shapes"] = shapes.hold(dev, "bench_serving", SEED + 64)
    return dict(int4_matmul=launches["int4"][0],
                paged_attention_serving=launches["bf16"][1]), results


def phase_speculative(dev):
    """Speculative decoding on the card on the induced-bigram int8
    checkpoint at Llama-3-8B width and depth: its top-1 margin makes greedy
    decode the same on every route in bf16, so speculative tokens must
    equal plain tokens, and the n-gram drafter's acceptance is a property
    of the period-16 text."""
    import numpy as np
    import torch
    from procyon_tpu_torch.inference import serving
    from procyon_tpu_torch.models import llama, synthetic
    from procyon_tpu_torch.scripts import bench_serving
    c = SPEC
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params, f = synthetic.ngram_quantized_params(cfg, period=c["period"],
                                                 seed=SEED + 32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pcfg = bench_serving.pool_config(serving_args(), cfg)
    rng = np.random.default_rng(SEED + 32)
    prompts = [list(map(int, rng.integers(4, cfg.vocab_size,
                                          int(rng.integers(*c["prompt"])))))
               for _ in range(c["requests"])]
    chains = []
    for p in prompts:
        tok, chain = p[-1], []
        for _ in range(c["max_new"]):
            tok = int(f[tok])
            chain.append(tok)
        chains.append(chain)
    runs = {}
    for name, kw in (("plain, 8-step rounds", dict(step_quantum=8)),
                     ("spec_k 7", dict(spec_k=c["spec_k"])),
                     ("spec_k 7, spec_quantum 4",
                      dict(spec_k=c["spec_k"], spec_quantum=4))):
        b = serving.ContinuousBatcher(params, cfg, pcfg, **kw)
        rids = [b.submit(p, max_new=c["max_new"]) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ForwardLog() as flog:
            out = b.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[name] = ([out[r] for r in rids], dt, dict(b.spec_stats),
                      len(flog.calls) - len(prompts))
        del b
    plain = runs["plain, 8-step rounds"][0]
    check(plain == chains, "plain greedy decode left the checkpoint's chain")
    print(f"speculative decoding: induced-bigram int8 checkpoint at "
          f"Llama-3-8B width, {cfg.n_layers} layers (period {c['period']}; "
          f"built in {build_s:.1f} s), {c['requests']} requests of "
          f"{c['prompt'][0]}-{c['prompt'][1] - 1} prompt tokens, "
          f"{c['max_new']} new tokens, 16 slots; plain greedy walks the "
          f"chain f on all {c['requests']} requests")
    out = {}
    for name, (toks, dt, stats, forwards) in runs.items():
        check(toks == plain, f"{name}: tokens differ from plain greedy")
        acc = stats["emitted"] / stats["rounds"] if stats["rounds"] else None
        out[name] = dict(seconds=dt, decode_forwards=forwards,
                         tokens_per_sec=c["requests"] * c["max_new"] / dt,
                         acceptance=acc)
        print(f"  {name}: tokens equal to plain greedy; {dt:.2f} s, "
              f"{out[name]['tokens_per_sec']:.1f} tokens/s, {forwards} "
              f"decode forwards"
              + (f", {stats['emitted']} tokens in {stats['rounds']} "
                 f"slot-rounds: {acc:.3f} accepted a round (of "
                 f"{c['spec_k'] + 1})" if acc else ""))
    del params
    torch.cuda.empty_cache()
    return out


def phase_generate_http(dev, service):
    """POST /generate from four concurrent HTTP clients against a
    GenerationService over a bf16 batcher on the serving path's decoder and
    pool (no prefix cache: a prompt sent again would otherwise skip the
    prefill it got the first time); each answer equals the tokens the same
    prompt gets alone, through the same service."""
    import numpy as np
    from procyon_tpu_torch.app import server
    from procyon_tpu_torch.inference import serving
    from procyon_tpu_torch.ops import paged_attention
    from procyon_tpu_torch.scripts import bench_serving
    lcfg = service.cfg.llama
    batcher = serving.ContinuousBatcher(
        service.params["llama"], lcfg,
        bench_serving.pool_config(serving_args(), lcfg),
        step_quantum=SERVING["step_quantum"])
    rng = np.random.default_rng(SEED + 33)
    vocab = batcher.cfg.vocab_size
    prompts = [list(map(int, rng.integers(4, vocab, n)))
               for n in (40, 120, 75, 18)]
    max_new = 16
    gen = server.GenerationService(batcher)
    httpd = server.serve(None, 0, gen=gen, host="127.0.0.1", background=True)
    try:
        port = httpd.server_address[1]
        answers = [None] * len(prompts)

        def client(i):
            answers[i] = post_json(port, "/generate", {
                "tokens": prompts[i], "max_new": max_new})

        before = paged_attention.launches
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        dt = time.perf_counter() - t0
        check(all(a is not None and a[0] == 200 for a in answers),
              f"/generate answered {answers}")
        check(paged_attention.launches > before, "/generate ran no decode "
                                                 "step on the kernel")
        solo = [post_json(port, "/generate", {"tokens": p,
                                              "max_new": max_new})
                for p in prompts]
    finally:
        httpd.shutdown()
        httpd.server_close()
    for i, (a, s) in enumerate(zip(answers, solo)):
        check(len(a[1]["tokens"]) == max_new, f"/generate {i}: "
                                              f"{len(a[1]['tokens'])} tokens")
        check(a[1]["tokens"] == s[1]["tokens"],
              f"/generate {i}: concurrent {a[1]['tokens']} != solo "
              f"{s[1]['tokens']}")
    print(f"POST /generate: {len(prompts)} concurrent clients (prompts of "
          f"{[len(p) for p in prompts]} tokens, {max_new} new tokens) "
          f"answered in {dt:.2f} s, each equal to the same prompt alone")


def grad_errors(out, ref):
    """A gradient of the backward kernels [B, S, H, D] against the plain
    version's: (the largest ratio of an element's error to its allowance,
    GRAD_ROW_TOL of its row's largest |plain| + GRAD_FLOOR of the tensor's
    + one bf16 ulp of itself; ||out - ref|| / ||ref||). Close when the
    first is at most 1 and the second at most GRAD_FRO_TOL."""
    out, ref = out.float(), ref.float()
    allow = (GRAD_ROW_TOL * ref.abs().amax(-1, keepdim=True)
             + GRAD_FLOOR * ref.abs().max() + RTOL * ref.abs())
    err = (out - ref).abs()
    ratio = (err / allow.clamp_min(1e-30)).max().item()
    fro = (err.norm() / ref.norm().clamp_min(1e-30)).item()
    return ratio, fro


def grad_close(out, ref):
    ratio, fro = grad_errors(out, ref)
    return ratio <= 1.0 and fro <= GRAD_FRO_TOL


def device_ms_by_kernel(fn, names, reps=5):
    """Device time a call of fn spends in each kernel whose name holds one
    of `names`, from one trace of `reps` calls (utils/profiling.profiled,
    arranged so that the trace keeps every kernel of the block); fails
    unless the trace holds every named kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from procyon_tpu_torch.utils import profiling
    fn()
    torch.cuda.synchronize()
    with profiling.profiled([ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    found = {}
    for e in prof.key_averages():
        for n in names:
            if n in e.key and e.device_type == DeviceType.CUDA:
                found[n] = found.get(n, 0.0) \
                    + e.self_device_time_total / 1e3 / reps
    check(set(found) == set(names),
          f"the profiler saw {sorted(found)} of {list(names)}")
    return found


def kernels_a_call(fn, reps=4):
    """The device kernels one call of fn runs (copies, fills and the
    profiler's leading kernels aside), counted in one trace of `reps` calls
    (utils/profiling.profiled); fails when the trace holds no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from procyon_tpu_torch.utils import profiling
    fn()
    torch.cuda.synchronize()
    with profiling.profiled([ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not any(s in e.name for s in ("Memcpy", "Memset",
                                               profiling.LEAD_KERNEL))]
    check(bool(names), "the profiler saw no kernel")
    return len(names) / reps, sorted(set(names))


def device_ms_all(fn, reps=5):
    """Device time a call of fn spends in each kernel it runs, by kernel
    name (template arguments cut), from one trace of `reps` calls
    (utils/profiling.profiled, its leading kernels left out): the split of
    a wrapper's launches without naming them, so that it reads the kernels
    of any version of the wrapper. Fails when the trace holds no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from procyon_tpu_torch.utils import profiling
    fn()
    torch.cuda.synchronize()
    with profiling.profiled([ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    found = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA \
                and profiling.LEAD_KERNEL not in e.key:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("<")[0]
            name = name.split("(")[0].strip()
            found[name] = found.get(name, 0.0) \
                + e.self_device_time_total / 1e3 / reps
    check(bool(found), "the profiler saw no kernel")
    return found


def sdpa_bwd_ms(q, k, v, do, mask):
    """The backward of F.scaled_dot_product_attention (the library call,
    used nowhere in the port) on the same tensors: forward + backward less
    the forward alone. mask None is is_causal=True, else a boolean
    [B, Sq, Skv] mask."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    kw = dict(is_causal=True) if mask is None else dict(
        attn_mask=mask[:, None])
    gqa = qt.shape[1] != kt.shape[1]

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=gqa,
                                              **kw)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    return cuda_ms(fwd_bwd) - cuda_ms(fwd)


def flash_bwd_case(name, q, k, v, seg, *, q_pos=None, kv_pos=None,
                   causal=True, seg_kv=None):
    """One shape of the backward kernels (causal unless said): dq, dk and
    dv against flash_bwd_ref on the same bf16 inputs, rows and keys nothing
    allows exactly 0; times for the pair (CUDA events; the dq kernel
    computes delta, so there is no pass between the two), for each kernel
    (the profiler's device time), the plain version and the library call;
    the bounds from this run's masks. seg_kv: the keys' segment ids when
    they differ from the queries' (a prefix). Returns the two kernels'
    entries of the JSON line."""
    import torch
    from procyon_tpu_torch.ops import flash_attention as fa
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    sm = D ** -0.5
    ints = fa.mask_inputs(q, k, seg, seg if seg_kv is None else seg_kv,
                          q_pos, kv_pos)
    bounded = q_pos is None and q.shape[1] == k.shape[1]
    out, lse = fa.flash_fwd(q, k, v, *ints, causal=causal, sm_scale=sm,
                            bounded=bounded, want_lse=True)
    g = torch.Generator(device=q.device).manual_seed(SEED + 31)
    do = torch.randn(out.shape, generator=g, device=q.device).to(
        torch.bfloat16)

    def kernel():
        return fa.flash_bwd(q, k, v, *ints, out, lse, do, causal=causal,
                            sm_scale=sm, bounded=bounded)

    def plain():
        return fa.flash_bwd_ref(q, k, v, *ints, out, lse, do, causal=causal,
                                sm_scale=sm)

    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check((fa.launches_bwd_dq, fa.launches_bwd_dkv)
          == (before[0] + 1, before[1] + 1),
          f"{name}: the wrapper did not launch both kernels")
    check(all(torch.equal(a, b) for a, b in zip(got, kernel())),
          f"{name}: two launches on the same inputs differ")
    errs, held = {}, {}
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[what] = (a.float() - b.float()).abs().max().item()
        held[what] = grad_errors(a, b)
        check(torch.isfinite(a.float()).all().item(),
              f"{name}: {what} not finite")
        check(grad_close(a, b), f"{name}: {what} max_abs_err {errs[what]}, "
                                f"(error / allowance, relative norm) "
                                f"{held[what]}")
    dq, dk, dv = got
    if seg is None:
        # the check must see a fault confined to the last tile, where the
        # gradients are smallest: the last 64 queries' dq lost, the last 64
        # keys' dv doubled (they get their whole value from the diagonal
        # tile). Beside it, the error against GRAD_ROW_TOL of the tensor's
        # largest |plain| (+ one ulp) alone, without the rows' own scale
        for what, i, f in (("dq of the last 64 queries lost", 0, 0.0),
                           ("dv of the last 64 keys doubled", 2, 2.0)):
            a = torch.cat([got[i][:, :-64], f * got[i][:, -64:]], 1).float()
            b = want[i].float()
            ratio, fro = grad_errors(a, b)
            whole = ((a - b).abs() / (GRAD_ROW_TOL * b.abs().max()
                                      + RTOL * b.abs())).max().item()
            check(not grad_close(a, b), f"{name}: the check passes a fault "
                                        f"in the last tile: {what}")
            print(f"{name}, a fault, {what}: error / allowance {ratio:.2f}, "
                  f"relative norm {fro:.2e} (caught); against "
                  f"{GRAD_ROW_TOL} of the tensor's largest alone {whole:.2f}")
    dead_q = (lse <= -1e29).permute(0, 2, 1)                 # [B, S, Hq]
    check(not dq[ints[0] == 0].any().item() and not dq[dead_q].any().item()
          and not dk[ints[1] == 0].any().item()
          and not dv[ints[1] == 0].any().item(),
          f"{name}: a padded or dead row's gradient is not 0")
    pair_ms, plain_ms = paired_ms(kernel, plain)
    split = device_ms_by_kernel(kernel, ("flash_bwd_dq", "flash_bwd_dkv"))
    pairs, ok = allowed_pairs(ints[0], ints[1], causal, ints[2], ints[3])
    library_ms = sdpa_bwd_ms(q, k, v, do, None if seg is None else ok)
    # inputs each kernel reads: the live q, do, k, v rows, lse and delta
    # (f32 [B, Hq, S]) and the four int arrays; the dq kernel writes delta
    # (as many bytes as dk / dv read) and reads the live out rows for it
    n_in = (live_bytes(q, ints[0]) + live_bytes(do, ints[0])
            + live_bytes(k, ints[1]) + live_bytes(v, ints[1])
            + 2 * nbytes(lse) + nbytes(*ints))
    flop = 2 * D * Hq * pairs                # one product over the pairs
    b_dq = bound(n_in + live_bytes(out, ints[0]) + nbytes(dq), 3 * flop,
                 PEAK_BF16)
    b_dkv = bound(n_in + nbytes(dk, dv), 4 * flop, PEAK_BF16)
    b_all = bound(n_in - nbytes(lse) + nbytes(out, dq, dk, dv), 5 * flop,
                  PEAK_BF16)
    shape = f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D}" + (
        f" Skv{k.shape[1]}" if k.shape[1] != S else "")
    print(f"{name} {shape} {'causal' if causal else 'bidirectional'}"
          f"{' bounded' if bounded else ''}: "
          f"max_abs_err dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv "
          f"{errs['dv']:.3e}; largest error / allowance ({GRAD_ROW_TOL} "
          f"row max|plain| + {GRAD_FLOOR} max|plain| + {RTOL}|plain|) dq "
          f"{held['dq'][0]:.4f} dk {held['dk'][0]:.4f} dv "
          f"{held['dv'][0]:.4f} (<= 1), ||kernel - plain|| / ||plain|| dq "
          f"{held['dq'][1]:.3e} dk {held['dk'][1]:.3e} dv "
          f"{held['dv'][1]:.3e} (<= {GRAD_FRO_TOL}), two launches bitwise "
          f"equal; both kernels {pair_ms:.4f} ms (events; delta inside "
          f"the dq kernel), dq {split['flash_bwd_dq']:.4f} ms, dkv "
          f"{split['flash_bwd_dkv']:.4f} ms (device); plain {plain_ms:.4f} "
          f"ms, sdpa backward {library_ms:.4f} ms; bound of the backward "
          f"{b_all[0]:.4f} ms by {b_all[1]} ({5 * flop / 1e9:.1f} GFLOP "
          f"over {pairs} allowed pairs), dq {b_dq[0]:.4f} ms, dkv "
          f"{b_dkv[0]:.4f} ms")
    common = dict(route="cuda",
                  source="procyon_tpu_torch/csrc/flash_attention_bwd.cu",
                  shape=shape, pair_ms=pair_ms, plain_ms=plain_ms,
                  library_ms=library_ms, whole_bound_ms=b_all[0],
                  plain_and_library_of="the whole backward (dq, dk, dv)")
    return [dict(name="flash_attention_bwd_dq",
                 replaces="procyon_tpu/ops/flash_attention.py:388",
                 max_abs_err=errs["dq"], ms=split["flash_bwd_dq"],
                 bound_ms=b_dq[0], bound_by=b_dq[1], **common),
            dict(name="flash_attention_bwd_dkv",
                 replaces="procyon_tpu/ops/flash_attention.py:443",
                 max_abs_err=max(errs["dk"], errs["dv"]),
                 ms=split["flash_bwd_dkv"], bound_ms=b_dkv[0],
                 bound_by=b_dkv[1],
                 **common)]


def phase_flash_bwd(dev):
    """Kernel rows 8 and 9 at Llama-3-8B widths (Hq 32, Hkv 8, D 128,
    causal): the training shape B2 x S2048; B4 x 512 with a right-padded,
    a dead and a packed row; B2 x 512 with positions given (a left-padded
    row), which the kernels may not bound. Returns the training shape's
    entries."""
    import torch
    Hq, Hkv, D = (FLASH_SHAPE[k] for k in ("Hq", "Hkv", "D"))
    g = torch.Generator(device=dev).manual_seed(SEED + 30)

    def qkv(B, S):
        return [torch.randn((B, S, H, D), generator=g, device=dev).to(
            torch.bfloat16) for H in (Hq, Hkv, Hkv)]

    entries = flash_bwd_case("flash bwd (training shape)",
                             *qkv(FLASH_BWD_TRAIN["B"], FLASH_BWD_TRAIN["S"]),
                             None)
    B, S = FLASH_BWD_MASKED["B"], FLASH_BWD_MASKED["S"]
    seg = torch.ones((B, S), dtype=torch.int32, device=dev)
    seg[1, S - 150:] = 0              # right-padded
    seg[2] = 0                        # dead
    seg[3, S // 2 + 7:] = 2           # a second packed segment
    flash_bwd_case("flash bwd (padded, dead, packed rows)", *qkv(B, S), seg)
    seg = torch.ones((2, S), dtype=torch.int32, device=dev)
    seg[1, :100] = 0                  # a left-padded prompt
    pos = torch.stack([torch.arange(S, device=dev) + 37,
                       (torch.arange(S, device=dev) - 100).clamp_min(0)]).to(
        torch.int32)
    flash_bwd_case("flash bwd (positions given)", *qkv(2, S), seg,
                   q_pos=pos, kv_pos=pos)
    return entries


def trainable_grads(opt, state, cfg, batch):
    """(loss, {path: gradient}) of the QA loss on expert 0, as the step
    computes them, over the state's trainable leaves."""
    from procyon_tpu_torch.training import train_step as ts
    loss, _, items, grads = ts.value_and_grad(
        opt, state, True,
        lambda p: ts.lm_loss_fn(p, cfg, batch, 1.0, lora_expert=0))
    return loss, {"/".join(p): g for (p, _), g in zip(items, grads)}


def leaves_by_path(tree):
    """{path: leaf as f32 on the CPU}, a copy."""
    from procyon_tpu_torch.training import optimizer as topt
    return {"/".join(p): t.detach().float().cpu().clone()
            for p, t in topt.tree_items(tree)}


def phase_train_small(dev):
    """One QA train step (make_train_step(..., "qa", frozen_base=True)) on
    the card in bf16 against the same step on the CPU in f32 from the same
    weights: ProCyon-Full widths cut to 2 layers and vocab 8192, an int8
    frozen base, LoRA r16 x 4 with nonzero B. Checks the loss, the cosine of
    every trainable leaf's gradient and update against the CPU's, and the
    card's parameters after the update against the same update computed in
    f32 from the card's start and gradients."""
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.app.main import procyon_full_config
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.scripts import bench_train
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    s = TRAIN_SMALL
    full = procyon_full_config(s["layers"])
    cfg = bench_train.qlora_config(dataclasses.replace(
        full, llama=dataclasses.replace(full.llama, vocab_size=s["vocab"])),
        TRAIN["lora_rank"], TRAIN["lora_experts"])
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    params = bench_train.qlora_params(
        unified.init_params(SEED + 32, cfg, device=dev), cfg, g,
        b_scale=TRAIN_SMALL_B)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                llama=dataclasses.replace(
                                    cfg.llama, dtype=torch.float32,
                                    lora=dataclasses.replace(
                                        cfg.llama.lora,
                                        dtype=torch.float32)))
    p32 = bridge.to_torch(bridge.to_numpy(params), device="cpu")
    batch = bench_train.train_batch(s["B"], s["S"], s["vocab"],
                                    cfg.protein_embed_dim, SEED + 33,
                                    TRAIN["soft_tokens"])
    ocfg = topt.OptimizerConfig(lr=TRAIN["lr"], warmup_steps=0,
                                total_steps=1000)
    runs, seen = {}, {}
    t0 = time.perf_counter()
    for where, c, p in (("card", cfg, params), ("cpu", cfg32, p32)):
        opt = topt.build_optimizer(ocfg)
        state = ts.init_train_state(
            p, opt, trainable_predicate=ts.lora_trainable_predicate)
        if where == "card":
            update, start32 = opt.update, topt.tree_map(
                lambda t: t.detach().float().cpu().clone(), state["params"])

            def record(items, grads, st, **kw):
                # the gradients the card's step hands its optimizer
                seen.update({"/".join(q): g.detach().float().cpu()
                             for (q, _), g in zip(items, grads)})
                update(items, grads, st, **kw)
            opt.update = record
        b = ts.batch_to_device(batch, dev if where == "card" else "cpu")
        before = fa.launches_bwd_dq
        loss, grads = trainable_grads(opt, state, c, b)
        if where == "card":
            check(fa.launches_bwd_dq - before == s["layers"],
                  "small training check: the card run did not take the "
                  "backward kernels")
        start = leaves_by_path(state["params"])
        state, m = ts.make_train_step(c, opt, "qa", frozen_base=True)(state,
                                                                      b)
        check(abs(float(m["loss"]) - float(loss)) <= 1e-6 * abs(float(loss))
              + 1e-6, "the step's loss differs from the loss function's")
        after = leaves_by_path(state["params"])
        runs[where] = (float(loss), {k: v.float().cpu()
                                     for k, v in grads.items()},
                       start, after)
    cpu_s = time.perf_counter() - t0
    (l_gpu, g_gpu, s_gpu, a_gpu), (l_cpu, g_cpu, s_cpu, a_cpu) = \
        runs["card"], runs["cpu"]
    check(abs(l_gpu - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu),
          f"small training: loss {l_gpu} on the card, {l_cpu} on the CPU")
    cos_min, upd_min, worst = 1.0, 1.0, 0.0
    lr = TRAIN["lr"]
    for k, gc in g_cpu.items():
        gg = g_gpu[k]
        check(torch.isfinite(gg).all().item(), f"{k}: gradient not finite")
        # a leaf the QA loss does not reach has no gradient on either side
        if not gc.any():
            check(not gg.any(), f"{k}: a gradient on the card only")
            continue
        cos = torch.nn.functional.cosine_similarity(
            gg.flatten(), gc.flatten(), dim=0).item()
        check(cos >= TRAIN_GRAD_COS, f"{k}: gradient cosine {cos}")
        cos_min = min(cos_min, cos)
        du_gpu, du_cpu = a_gpu[k] - s_gpu[k], a_cpu[k] - s_cpu[k]
        upd = torch.nn.functional.cosine_similarity(
            du_gpu.flatten(), du_cpu.flatten(), dim=0).item()
        check(upd >= TRAIN_UPDATE_COS, f"{k}: update cosine {upd}")
        upd_min = min(upd_min, upd)
    opt32 = topt.build_optimizer(ocfg)
    items32 = opt32.trainable_items(start32)
    opt32.update(items32, [seen["/".join(q)] for q, _ in items32],
                 opt32.init(start32))
    for q, want in items32:
        # bf16 rounds the card's value (half an ulp, at most 2^-8 of it)
        k = "/".join(q)
        dev_ = (a_gpu[k] - want).abs() - RTOL * want.abs()
        worst = max(worst, dev_.max().item() / lr)
    check(worst <= TRAIN_PARAM_STEPS, f"a parameter after the update is "
                                      f"{worst} lr from the f32 update of "
                                      f"the card's gradients")
    print(f"training check (ProCyon-Full widths, {s['layers']} layers, vocab "
          f"{s['vocab']} for this check only, int8 base, LoRA "
          f"r{TRAIN['lora_rank']}x{TRAIN['lora_experts']} with B ~ "
          f"N(0, {TRAIN_SMALL_B}^2), B{s['B']} x S{s['S']}, one QA step at lr "
          f"{lr}): loss card bf16 {l_gpu:.5f}, CPU f32 {l_cpu:.5f} (rtol "
          f"{TRAIN_LOSS_RTOL}); gradient cosine min {cos_min:.6f} (>= "
          f"{TRAIN_GRAD_COS}), update cosine min {upd_min:.4f} (>= "
          f"{TRAIN_UPDATE_COS}), parameters after the update at most "
          f"{worst:.4f} lr beyond bf16 rounding from the f32 update of the "
          f"card's gradients (<= {TRAIN_PARAM_STEPS}); both runs "
          f"{cpu_s:.1f} s")


def frozen_checksums(tree):
    """Bit checksums of every frozen leaf (int64 sums of its bits)."""
    import torch
    from procyon_tpu_torch.training import optimizer as topt
    out = {}
    for path, leaf in topt.tree_items(tree):
        parts = leaf.values() if isinstance(leaf, dict) else [leaf]
        sums = []
        for t in parts:
            bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
                t.element_size()]
            sums.append(t.view(bits).sum(dtype=torch.int64))
        out["/".join(path)] = torch.stack(sums).cpu()
    return out


def profile_once(what, fn, untraced_ms):
    """torch.profiler over one call of fn (after a traced one, which pays
    the tracer's start): wall, device-busy time and kernels of the call, the
    device's idle share of the untraced call (`untraced_ms`, timed apart),
    and the kernels that take most of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        fn()
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{what} under torch.profiler: wall {wall:.1f} ms "
          f"(tracing on), device busy {busy:.1f} ms in "
          f"{sum(e.count for e in kernels)} kernels; of the untraced "
          f"{untraced_ms:.1f} ms the device idles "
          f"{1 - busy / untraced_ms:.2f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms in "
              f"{e.count:5d} launches  {e.key[:90]}")
    return dict(traced_wall_ms=wall, busy_ms=busy,
                kernels=sum(e.count for e in kernels),
                idle_share=1 - busy / untraced_ms)


def phase_train(dev, service, profile=False):
    """The slice's main path: QLoRA training at full Llama-3-8B width on
    the /retrieve phase's decoder, quantized to int8, with LoRA banks
    r16 x 4, the projectors and the contrastive temperature trained
    (train_step.lora_trainable_predicate), scripts/bench_train.py
    --flagship's B2 x S2048 batch, remat on, through bench_train's
    `qlora_config`, `qlora_params`, `train_batch` and `run`: the QA step
    (make_train_step(..., "qa", frozen_base=True)) warmed, then timed by
    bench_train's two points, then the combined QA + retrieval step on
    expert 3 (make_combined_step) the same way. Returns the launches of
    rows 3, 8 and 9 over the run."""
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.scripts import bench_train
    from procyon_tpu_torch.training import combined_step as tcs
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    t = TRAIN
    cfg = bench_train.qlora_config(service.cfg, t["lora_rank"],
                                   t["lora_experts"])
    lcfg = cfg.llama
    g = torch.Generator(device=dev).manual_seed(SEED + 34)
    params = bench_train.qlora_params(service.params, cfg, g)
    opt = topt.build_optimizer(topt.OptimizerConfig(
        lr=t["lr"], warmup_steps=t["warmup"], total_steps=1000))
    state = ts.init_train_state(
        params, opt, trainable_predicate=ts.lora_trainable_predicate)
    del params
    n_train = sum(x.numel() for _, x in topt.tree_items(state["params"]))
    start = {"/".join(p): x.clone() for p, x in
             topt.tree_items(state["params"])}
    frozen = frozen_checksums(state["frozen"])
    batch = ts.batch_to_device(bench_train.train_batch(
        t["B"], t["S"], lcfg.vocab_size, cfg.protein_embed_dim, SEED + 35,
        t["soft_tokens"]), dev)
    fpt = bench_train.train_flops_per_token(lcfg, t["S"], frozen_base=True,
                                            remat=True)
    n_params = sum(x.numel() for x in bridge.tree_leaves(
        llama.init_params(0, lcfg, device="meta")))
    tokens = t["B"] * t["S"]
    supervised = int((batch["labels"][:, 1:] != -100).sum().item())
    print(f"training: Llama-3-8B (int8 frozen base, {lcfg.n_layers} layers) "
          f"+ LoRA r{t['lora_rank']}x{t['lora_experts']} on wq / wv, "
          f"{n_train / 1e6:.1f} M trainable parameters, B{t['B']} x "
          f"S{t['S']} ({supervised} supervised tokens), remat; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card "
          f"with the /retrieve service's bf16 weights")
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    torch.cuda.reset_peak_memory_stats(dev)
    qa = ts.make_train_step(cfg, opt, "qa", frozen_base=True)
    results = {}
    state, m = qa(state, batch)
    first_loss = float(m["loss"])
    combined = tcs.make_combined_step(cfg, opt, expert_override=3,
                                      frozen_base=True)

    def joint(s, b):
        return combined(s, {"qa": b, "retrieval": b})

    for name, step, passes in (("qa", qa, 1), ("combined", joint, 2)):
        res = bench_train.run(
            step, state, batch, cfg, seq=t["S"], batch_size=t["B"],
            passes=passes, frozen_base=True, steps_small=t["small"],
            steps_big=t["big"], warm=t["warm"] - (name == "qa"),
            n_params=n_params, n_trainable=n_train,
            task_tag=f"{name} step", device=dev,
            wtag=f"int8 frozen base + bf16 LoRA "
                 f"r{t['lora_rank']}x{t['lora_experts']}")
        state, per = res["state"], res["launches_per_step"]
        check(all(math.isfinite(x) for x in res["losses"]),
              f"{name} step: losses {res['losses']}")
        check(per == [64 * passes, 32 * passes, 32 * passes],
              f"{name} step: launches of rows 3, 8, 9 a step {per}, "
              f"expected {[64 * passes, 32 * passes, 32 * passes]}")
        ms = res["per_step_s"] * 1e3
        check(ms > 0, f"{name} step: {ms} ms a step")
        mfu = fpt * tokens * passes / (ms / 1e3) / PEAK_BF16
        check(abs(mfu - res["line"]["mfu"]) <= 1e-4,
              f"{name} step: MFU {mfu} here, {res['line']['mfu']} in "
              "bench_train's line")
        results[name] = dict(ms_per_step=ms,
                             tokens_per_sec=tokens * passes / (ms / 1e3),
                             supervised_tokens_per_sec=supervised * passes
                             / (ms / 1e3),
                             mfu=mfu, last_loss=res["losses"][-1],
                             flash_fwd_launches_per_step=per[0],
                             flash_bwd_dq_launches_per_step=per[1],
                             flash_bwd_dkv_launches_per_step=per[2])
        print(f"  {name} step: {ms:.1f} ms a step (host clock, two points "
              f"at {t['small']} and {t['big']} steps, the best of two runs "
              f"each), "
              f"{tokens * passes / (ms / 1e3):.0f} tokens/s, "
              f"{supervised * passes / (ms / 1e3):.0f} supervised tokens/s, "
              f"MFU {mfu:.1%} ({fpt * tokens * passes:.3e} FLOP a step at "
              f"{PEAK_BF16:.3g}); last loss {res['losses'][-1]:.4f}; "
              f"launches a step: flash fwd {per[0]:g}, dq {per[1]:g}, dkv "
              f"{per[2]:g}")
        print(f"  bench_train: {json.dumps(res['line'])}")
    results["qa"]["first_loss"] = first_loss
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_bwd_dq": fa.launches_bwd_dq,
                "flash_attention_bwd_dkv": fa.launches_bwd_dkv}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    results["peak_gib"] = peak
    print(f"  peak memory {peak:.1f} GiB (the service's bf16 weights "
          f"included); loss first {first_loss:.4f}, last "
          f"{results['combined']['last_loss']:.4f}")
    after = frozen_checksums(state["frozen"])
    check(all(torch.equal(frozen[k], after[k]) for k in frozen),
          "a frozen leaf changed")
    unchanged = [k for k, x in ((("/".join(p)), x) for p, x in
                                topt.tree_items(state["params"]))
                 if torch.equal(x, start[k])]
    check(not unchanged, f"trainable leaves that did not change: {unchanged}")
    results["midtrain_eval"] = phase_midtrain_eval(
        dev, cfg, ts.merge_params(state["params"], state["frozen"]),
        service.store, service.tokenizer)
    if profile:
        profile_once("one QA train step", lambda: qa(state, batch),
                     results["qa"]["ms_per_step"])
    return launches, results


def phase_train_cli(dev):
    """run_pretrain --synthetic true --max_steps 20 on the card, in its own
    process: exit 0, final_step 20 on its JSON line, and its last
    checkpoint restores onto a live state of the same run's setup."""
    import tempfile

    import torch
    from procyon_tpu_torch.models import checkpoint_io
    from procyon_tpu_torch.scripts import run_pretrain
    from procyon_tpu_torch.training import checkpointing
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    steps = 20
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "run")
        argv = ["--synthetic", "true", "--max_steps", str(steps),
                "--output_dir", out_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "procyon_tpu_torch.scripts.run_pretrain",
             *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"run_pretrain exited {proc.returncode}"
                                    f": {proc.stderr[-3000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        check(last.get("final_step") == steps, f"run_pretrain said {last}")
        path = checkpointing.latest_checkpoint(out_dir)
        check(path is not None and path.endswith(f"checkpoint-{steps}"),
              f"last checkpoint {path}")
        run = run_pretrain.setup(argv)
        like = ts.init_train_state(run["params"], run["optimizer"])
        state = checkpointing.restore_checkpoint(path, like)
        leaves = [x for _, x in topt.tree_items(state["params"])]
        check(state["step"] > 0
              and state["opt_state"]["count"] == state["step"]
              and all(x.device.type == "cuda" for x in leaves)
              and all(torch.isfinite(x.float()).all().item() for x in leaves),
              "the restored checkpoint is not a live state on the card")
        changed = sum(not torch.equal(a, b) for (_, a), (_, b) in zip(
            topt.tree_items(state["params"]),
            topt.tree_items(like["params"])))
        check(changed > 0, "the checkpoint holds the initial parameters")
        tstate = checkpointing.load_training_state(path)
        check(tstate["global_step"] == steps, f"training state {tstate}")
        model, mcfg, mtok = checkpoint_io.load_model(path, device=dev)
        want = dict(topt.tree_items(ts.merge_params(state["params"],
                                                    state.get("frozen"))))
        got = dict(topt.tree_items(model))
        check(mcfg == run["ucfg"] and mtok is not None
              and set(got) == set(want)
              and all(torch.equal(got[k], want[k]) for k in want),
              "load_model does not give the checkpoint's model")
    print(f"run_pretrain --synthetic true --max_steps {steps}: exit 0 in "
          f"{wall:.1f} s, final_step {last['final_step']}; checkpoint-{steps} "
          f"restored onto the card ({state['step']} updates, {changed} of "
          f"{len(leaves)} leaves changed from the initial state) and "
          "loaded as a model by checkpoint_io.load_model")


def swiglu_layout(fm):
    """The weight layout fused_rms_swiglu_int8 reads without a copy, as its
    module says (SWIGLU_WEIGHT_LAYOUT): "out_in", [in, out] views of
    [out, in] storage, or "in_out", contiguous [in, out]; a module that
    does not say is the first version's, which reads "in_out"."""
    return getattr(fm, "SWIGLU_WEIGHT_LAYOUT", "in_out")


def swiglu_args(dev, M, d, H, seed, layout="out_in"):
    """bf16 x and norm weight, int8 gate / up / down quantized from seeded
    N(0, 1/fan_in) weights, as a decoder layer hands them over: [in, out]
    codes, as views of [out, in] storage with layout "out_in"."""
    import torch
    from procyon_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    ws = [quant.quantize(randn(*shape, scale=shape[0] ** -0.5))
          for shape in ((d, H), (d, H), (H, d))]
    if layout == "out_in":
        for w in ws:
            w["q"] = w["q"].t().contiguous().t()
    return [randn(M, d).to(torch.bfloat16),
            (1 + randn(d, scale=0.1)).to(torch.bfloat16)] \
        + [t for w in ws for t in (w["q"], w["s"])]


def swiglu_steps(out, ref, step):
    """(the largest error beyond one bf16 ulp of the plain value, in
    steps; the share of elements more than one ulp off)."""
    err = (out.float() - ref.float()).abs()
    ulp = RTOL * ref.float().abs()
    beyond = (err - ulp).clamp_min(0) / step
    return beyond.max().item(), (err > ulp).float().mean().item()


def swiglu_route(args, eps=1e-5):
    """The port's W8A8 MLP route on the same tensors (llama._mlp in
    "w8a8"): rms_norm, qmatmul_w8a8 gate and up, SiLU * u, qmatmul_w8a8
    down, the residual."""
    from procyon_tpu_torch.models import llama
    x, nw, gq, gs, uq, us, dq, ds = args
    lp = {"mlp_norm": nw, "mlp": {"w_gate": {"q": gq, "s": gs},
                                  "w_up": {"q": uq, "s": us},
                                  "w_down": {"q": dq, "s": ds}}}
    cfg = llama.LlamaConfig(dim=x.shape[1], norm_eps=eps)
    return llama._mlp(x, lp, cfg, "w8a8")


def mlp_cos(out, route, x):
    """Cosine of the two MLP outputs (the residual taken off)."""
    a = (out.float() - x.float()).flatten()
    b = (route.float() - x.float()).flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def swiglu_case(dev, M, d, H, seed):
    """Row 7 at one shape against its plain version (SWIGLU_STEPS), the
    two planted faults shown to fail that check, and the times of the
    kernel, the plain version and the W8A8 route (weights cold: 3 d H
    bytes of int8 exceed the 50 MB L2)."""
    import torch
    from procyon_tpu_torch.ops import fused_mlp as fm
    from procyon_tpu_torch.ops import quant
    args = swiglu_args(dev, M, d, H, seed)
    x, nw, gq, gs, uq, us, dq, ds = args
    G = fm.swiglu_group(d, H)
    out = fm.fused_rms_swiglu_int8(*args)
    ref = fm.fused_rms_swiglu_int8_ref(*args)
    xq, sx = fm.rms_quant_rows_ref(x, nw)
    aq, sa = fm.swiglu_codes_ref(xq, sx, gq, gs, uq, us, G)
    torch.cuda.synchronize()
    step = sa.amax(1, keepdim=True) * (dq.abs().amax(0, keepdim=True).float()
                                       * ds.reshape(1, -1).float())
    check(bool(torch.isfinite(out.float()).all().item()),
          f"fused_rms_swiglu_int8 H{H}: non-finite")
    steps, off = swiglu_steps(out, ref, step)
    check(steps <= SWIGLU_STEPS and off <= SWIGLU_OFF_ULP,
          f"fused_rms_swiglu_int8 M{M} d{d} H{H}: {steps:.2f} steps beyond "
          f"one ulp (tol {SWIGLU_STEPS}), {off:.2e} of the elements off by "
          f"more than one ulp (tol {SWIGLU_OFF_ULP})")
    check(torch.equal(out, fm.fused_rms_swiglu_int8(*args)),
          f"fused_rms_swiglu_int8 H{H}: two launches differ")
    # the codes the kernels pass between them against the plain stages:
    # the row codes, the SiLU * u codes against the plain version's, and
    # against the plain stage run on the kernel's own row codes (the
    # division and expf of the gate / up kernel alone)
    _, (kxq, ksx, kaq, _) = fm._launch_swiglu(*args, 1e-5, 512, 2)
    own, _ = fm.swiglu_codes_ref(kxq, ksx.reshape(-1, 1), gq, gs, uq, us, G)
    codes = dict(
        xq=int((kxq != xq).sum().item()), xq_of=kxq.numel(),
        xq_max=int((kxq.int() - xq.int()).abs().max().item()),
        aq=int((kaq != aq).sum().item()), aq_of=kaq.numel(),
        aq_own=int((kaq != own).sum().item()),
        aq_own_max=int((kaq.int() - own.int()).abs().max().item()))
    del kxq, ksx, kaq, own
    # planted faults: group j's scale doubled (its part added once more),
    # and the last row tile without its MLP (the residual alone)
    j = H // G // 2
    sl = slice(j * G, (j + 1) * G)
    part = quant.int_mm(aq[:, sl].contiguous(), dq[sl]).float() \
        * (sa[:, j:j + 1] * ds.reshape(1, -1).float())
    doubled = (out.float() + part).to(out.dtype)
    dropped = out.clone()
    dropped[-SWIGLU_ROW_TILE:] = x[-SWIGLU_ROW_TILE:]
    faults = {name: swiglu_steps(bad, ref, step)[0]
              for name, bad in (("group scale doubled", doubled),
                                ("last row tile dropped", dropped))}
    for name, n in faults.items():
        check(n > SWIGLU_STEPS, f"fused_rms_swiglu_int8: the planted fault "
                                f"({name}) passes the check ({n:.2f} steps)")
    del part, doubled, dropped, xq, aq
    # the route on the layout the decoder keeps, contiguous [in, out]
    route_args = [t.contiguous() for t in args]
    route = swiglu_route(route_args)
    cos = mlp_cos(out, route, x)
    check(cos >= QUALITY_GATE_COS, f"fused_rms_swiglu_int8 H{H}: MLP cosine "
                                   f"{cos} to the W8A8 route")

    def kernel():
        return fm.fused_rms_swiglu_int8(*args)

    ms, plain_ms = paired_ms(kernel,
                             lambda: fm.fused_rms_swiglu_int8_ref(*args))
    route_ms = cuda_ms(lambda: swiglu_route(route_args))
    split = device_ms_all(kernel)
    # what the K-major layout saves: the same call on contiguous [in, out]
    # weights, which the wrapper transposes at every call
    copy_ms = cuda_ms(lambda: fm.fused_rms_swiglu_int8(*route_args))
    del route_args
    ops = 6 * M * d * H
    n_bytes = nbytes(x, nw, gq, gs, uq, us, dq, ds, out)
    bound_ms, bound_by = bound(n_bytes, ops, PEAK_INT8)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"fused rms swiglu int8 M{M} d{d} H{H} G{G}: {steps:.2f} steps "
          f"beyond one ulp (tol {SWIGLU_STEPS}), {off:.2e} of the elements "
          f"more than one ulp off (tol {SWIGLU_OFF_ULP}), max_abs_err "
          f"{err:.3e}; planted faults "
          + ", ".join(f"{k} {v:.1f} steps" for k, v in faults.items())
          + f" (fail, as they must); codes that differ from the plain "
          f"version's: row codes {codes['xq']} of {codes['xq_of']} (by at "
          f"most {codes['xq_max']}), SiLU*u codes {codes['aq']} of "
          f"{codes['aq_of']}, and {codes['aq_own']} (by at most "
          f"{codes['aq_own_max']}) against the plain stage on the kernel's "
          f"own row codes; MLP cosine to the W8A8 route {cos:.6f}"
          f"; kernels {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s; device time: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; on contiguous [in, out] weights, transposed at each call, "
          f"{copy_ms:.4f} ms), plain {plain_ms:.4f} ms, W8A8 route "
          f"{route_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({ops / 1e12:.3f} T int8 ops, {n_bytes / 1e6:.1f} MB)")
    return dict(shape=f"M{M} d{d} H{H}", G=G, max_abs_err=err,
                steps=steps, off_ulp=off, faults=faults, codes=codes,
                cos_route=cos,
                ms=ms, plain_ms=plain_ms, route_ms=route_ms,
                bound_ms=bound_ms, bound_by=bound_by, device_ms=split,
                in_out_ms=copy_ms)


def bf16_ulp(ref):
    """One bf16 ulp at each reference value's magnitude (at least the
    smallest normal's)."""
    import torch
    mag = ref.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_gelu_erf(dev):
    """The bias add + erf-GELU forward and backward kernels at ESM2-3B's
    index call (GELU_SHAPE, bf16, 3 N(0, 1) rows so the clamp is active on
    5% of them): one launch each; the forward against the plain chain
    (gelu_erf_ref of x + b), the backward (through GeluErf, as autograd
    runs it) against torch.autograd of the plain chain, each within the
    tolerances of GELU_SHAPE's comment. Times by CUDA events: the forward
    in turns with the plain chain, the library's F.gelu(x + b)
    (approximate="none", its own erf) beside it; the backward alone (a
    retained graph's grad), the plain chain's backward summed over its row
    blocks, and F.gelu's backward. Bounds: 4 bytes an element forward, 6
    backward, and the bias. Returns the two kernels' entries."""
    import torch
    import torch.nn.functional as F
    from procyon_tpu_torch.ops import activations as act
    M, Fw = GELU_SHAPE["M"], GELU_SHAPE["F"]
    g = torch.Generator(device=dev).manual_seed(SEED + 70)
    x = (3 * torch.randn((M, Fw), generator=g, device=dev)).to(torch.bfloat16)
    b = (0.5 * torch.randn((Fw,), generator=g, device=dev)).to(torch.bfloat16)
    gout = torch.randn((M, Fw), generator=g, device=dev).to(torch.bfloat16)
    shape = (f"M{M} F{Fw} bf16 + bias (ESM2-3B's MLP over an index call of "
             "128 x 1,026 rows)")

    before = (act.launches, act.launches_bwd)
    out = act.gelu_erf_fast(x, b)
    torch.cuda.synchronize()
    check((act.launches, act.launches_bwd) == (before[0] + 1, before[1]),
          "gelu_erf: not one forward launch a call")
    ref = act.gelu_erf_ref(x + b)
    diff = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref)
    worst_ulp = (diff / ulp).max().item()
    max_err = diff.max().item()
    same = (out == ref).sum().item() / out.numel()
    del diff, ulp
    check(worst_ulp <= 1 and same >= GELU_SAME,
          f"gelu_erf forward: {worst_ulp} bf16 ulps off the plain chain at "
          f"worst, {same:.6f} of the elements the same bits")
    again = act.gelu_erf_fast(x, b)
    check(torch.equal(out, again), "gelu_erf: two launches differ")
    del again, ref
    torch.cuda.empty_cache()
    ms, plain_ms = paired_ms(lambda: act.gelu_erf_fast(x, b),
                             lambda: act.gelu_erf_ref(x + b))
    library_ms = cuda_ms(lambda: F.gelu(x + b))
    bound_ms, bound_by = bound(nbytes(x, b, out), 0, PEAK_BF16)
    del out
    torch.cuda.empty_cache()

    xk = x.clone().requires_grad_(True)
    yk = act.gelu_erf_fast(xk, b)
    before = (act.launches, act.launches_bwd)
    (dx,) = torch.autograd.grad(yk, xk, gout, retain_graph=True)
    torch.cuda.synchronize()
    check((act.launches, act.launches_bwd) == (before[0], before[1] + 1),
          "gelu_erf: not one backward launch a call")
    part = M // GELU_BWD_PARTS
    worst, same_bwd, max_err_bwd, plain_bwd_ms = -math.inf, 0.0, 0.0, 0.0
    for i in range(GELU_BWD_PARTS):
        rows = slice(i * part, M if i == GELU_BWD_PARTS - 1
                     else (i + 1) * part)
        xr = x[rows].clone().requires_grad_(True)
        yr = act.gelu_erf_ref(xr + b)
        (want,) = torch.autograd.grad(yr, xr, gout[rows], retain_graph=True)
        d = (dx[rows].float() - want.float()).abs()
        tol = bf16_ulp(want) + 2.0 ** -20 * gout[rows].float().abs()
        worst = max(worst, (d - tol).max().item())
        max_err_bwd = max(max_err_bwd, d.max().item())
        same_bwd += (dx[rows] == want).sum().item()
        del d, tol, want
        plain_bwd_ms += cuda_ms(lambda: torch.autograd.grad(
            yr, xr, gout[rows], retain_graph=True), iters=3, warmup=1)
        del xr, yr
        torch.cuda.empty_cache()
    same_bwd /= M * Fw
    check(worst <= 0 and same_bwd >= GELU_SAME_BWD,
          f"gelu_erf backward: {worst} past one bf16 ulp + 2^-20 |g| of "
          f"autograd of the plain chain at worst, {same_bwd:.6f} of the "
          "elements the same bits")
    ms_bwd = cuda_ms(lambda: torch.autograd.grad(yk, xk, gout,
                                                 retain_graph=True))
    bound_bwd_ms, bound_bwd_by = bound(nbytes(gout, x, b, dx), 0, PEAK_BF16)
    del xk, yk, dx
    torch.cuda.empty_cache()
    xl = x.clone().requires_grad_(True)
    yl = F.gelu(xl + b)
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        yl, xl, gout, retain_graph=True))
    del xl, yl, x, gout
    torch.cuda.empty_cache()
    print(f"bias add + erf-GELU {shape}: forward {worst_ulp:.2f} bf16 ulp "
          f"at worst, {same:.6f} the plain chain's bits (tol 1 ulp, "
          f"{GELU_SAME}); kernel {ms:.4f} ms, plain chain {plain_ms:.4f} ms, "
          f"F.gelu(x + b) {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}; backward {same_bwd:.6f} autograd's bits (tol 1 ulp "
          f"+ 2^-20 |g|, {GELU_SAME_BWD}); kernel {ms_bwd:.4f} ms, plain "
          f"chain's backward {plain_bwd_ms:.4f} ms ({GELU_BWD_PARTS} row "
          f"blocks), F.gelu's {library_bwd_ms:.4f} ms, bound "
          f"{bound_bwd_ms:.4f} ms by {bound_bwd_by}")
    common = dict(route="cuda", source="procyon_tpu_torch/csrc/gelu_erf.cu",
                  replaces="none (procyon_tpu/ops/activations.py:33, "
                           "plain jnp that XLA fuses)", shape=shape)
    return [dict(name="gelu_erf", **common, max_abs_err=max_err,
                 max_ulp=worst_ulp, same_bits=same, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms),
            dict(name="gelu_erf_bwd", **common, max_abs_err=max_err_bwd,
                 same_bits=same_bwd, ms=ms_bwd, plain_ms=plain_bwd_ms,
                 bound_ms=bound_bwd_ms, bound_by=bound_bwd_by,
                 library_ms=library_bwd_ms)]


def phase_swiglu(dev):
    """Kernel row 7 at the Bind prefill's MLP and at Llama-3-8B's; the
    kernels line carries the first (the shape of the path it runs on)."""
    import torch
    cases = []
    for i, (M, d, H) in enumerate(SWIGLU_SHAPES):
        cases.append(swiglu_case(dev, M, d, H, SEED + 40 + i))
        torch.cuda.empty_cache()
    main, other = cases
    return dict(name="fused_rms_swiglu_int8", route="cuda",
                source="procyon_tpu_torch/csrc/fused_rms_swiglu_int8.cu",
                replaces="procyon_tpu/ops/fused_mlp.py:507",
                shape=main["shape"] + ", weights cold",
                max_abs_err=main["max_abs_err"], ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                route_ms=main["route_ms"], cos_route=main["cos_route"],
                steps=main["steps"], faults=main["faults"],
                codes=main["codes"],
                device_ms=main["device_ms"], in_out_ms=main["in_out_ms"],
                h14336={k: other[k] for k in ("ms", "plain_ms", "route_ms",
                                              "bound_ms", "steps", "codes",
                                              "cos_route", "device_ms",
                                              "in_out_ms")})


def w8a8_cpu_copy(params, cfg):
    """The card's parameters and config in f32 on the CPU's reference
    attention."""
    import torch
    from procyon_tpu_torch import bridge
    cfg32 = dataclasses.replace(
        cfg, dtype=torch.float32, llama=dataclasses.replace(
            cfg.llama, dtype=torch.float32, attn_backend="ref"))
    return bridge.to_torch(bridge.to_numpy(params), device="cpu"), cfg32


def readout_errors(at, ref, yes, no):
    """The card's logits at the answer positions (at [n, vocab]) against
    the CPU's (ref): (the least cosine of a row to the CPU's, each row
    centred over the vocabulary; the largest error of the yes / no
    log-odds over the CPU's largest |log-odds|)."""
    import torch
    at = torch.as_tensor(at).float().cpu()
    ref = torch.as_tensor(ref).float().cpu()
    cos = cosines(at - at.mean(1, keepdim=True),
                  ref - ref.mean(1, keepdim=True)).min().item()
    z, zr = at[:, yes] - at[:, no], ref[:, yes] - ref[:, no]
    return cos, ((z - zr).abs().max() / zr.abs().max()).item()


def check_readout(at, ref, early, yes, no, what):
    """readout_errors within SANITY_COS and READOUT_LOGODDS_REL, and two
    planted faults shown to fail that check: the logits one position
    before the answer (`early`, the card's) and yes and no swapped. Returns
    the printed summary."""
    import torch

    def ok(e):
        return e[0] >= SANITY_COS and e[1] <= READOUT_LOGODDS_REL

    swapped = torch.as_tensor(at).clone()
    swapped[:, [yes, no]] = swapped[:, [no, yes]]
    good = readout_errors(at, ref, yes, no)
    faults = {"answer one position early": readout_errors(early, ref, yes,
                                                          no),
              "yes and no swapped": readout_errors(swapped, ref, yes, no)}
    check(ok(good), f"{what}: answer logits' row cosine {good[0]} (tol "
                    f"{SANITY_COS}), log-odds error {good[1]} of the "
                    f"largest (tol {READOUT_LOGODDS_REL})")
    for name, e in faults.items():
        check(not ok(e), f"{what}: the planted fault ({name}) passes the "
                         f"readout check: {e}")
    return (f"answer logits' row cosine {good[0]:.6f} (tol {SANITY_COS}), "
            f"log-odds error {good[1]:.4f} of the largest (tol "
            f"{READOUT_LOGODDS_REL}); planted faults "
            + ", ".join(f"{k}: cosine {c:.4f}, log-odds error {r:.3f}"
                        for k, (c, r) in faults.items())
            + " (fail, as they must)")


def phase_w8a8_small(dev):
    """bench_bind's and bench_retrieval's W8A8 forwards on a 2-layer copy
    of the bench decoder (full width): the card in bf16 against the CPU in
    f32 on the same int8 weights: the Bind yes-probabilities within
    W8A8_SMALL_PROB_ATOL and their logits by check_readout, the retrieval
    query embeddings' cosine at least SANITY_COS (their top-10 over 2,000
    targets printed). Returns the copy (card and CPU) for phase_qa_eval."""
    import torch
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.scripts import bench_bind, bench_retrieval
    cfg = bench_bind.bind_config(layers=W8A8_SMALL_LAYERS)
    params = unified.quantize_params(
        unified.init_params(SEED + 31, cfg, device=dev), cfg)
    p32, cfg32 = w8a8_cpu_copy(params, cfg)
    B, L = W8A8["B"], W8A8["L"]
    out = {}
    t0 = time.perf_counter()
    for where, p, c, d in (("card", params, cfg, dev),
                           ("cpu", p32, cfg32, "cpu")):
        with torch.no_grad():
            bind = bench_bind.bind_batch(c, B, L, d)
            at = bench_bind.answer_logits(p, c, bind)
            if where == "card":
                early = bench_bind.answer_logits(
                    p, c, dict(bind, answer_pos=bind["answer_pos"] - 1))
            batch, targets = bench_retrieval.retrieval_batch(c, B, L, 2000,
                                                             d)
            q, _, ids = bench_retrieval.retrieve(p, c, batch, targets)
        out[where] = (at.float().cpu(), q.float().cpu(), ids.cpu())
    probs = {k: torch.softmax(v[0][:, [bench_bind.YES_ID,
                                       bench_bind.NO_ID]], -1)[:, 0]
             for k, v in out.items()}
    gap = (probs["card"] - probs["cpu"]).abs().max().item()
    cos = cosines(out["card"][1], out["cpu"][1]).min().item()
    shared = min(len(set(a.tolist()) & set(b.tolist()))
                 for a, b in zip(out["card"][2], out["cpu"][2]))
    readout = check_readout(out["card"][0], out["cpu"][0], early.cpu(),
                            bench_bind.YES_ID, bench_bind.NO_ID,
                            "W8A8 small check (Bind)")
    print(f"W8A8 prefill check ({W8A8_SMALL_LAYERS} layers of the bench "
          f"decoder at full width, B{B} x L{L}): card bf16 against CPU f32, "
          f"Bind yes-probability within {gap:.2e} (tol "
          f"{W8A8_SMALL_PROB_ATOL}), {readout}; retrieval embedding cosine "
          f"{cos:.6f} (tol {SANITY_COS}), top-10 overlap at least "
          f"{shared}/10 (both runs {time.perf_counter() - t0:.1f} s)")
    check(gap <= W8A8_SMALL_PROB_ATOL, f"W8A8 small check: yes-probability "
                                       f"{gap} off")
    check(cos >= SANITY_COS, f"W8A8 small check: embedding cos {cos}")
    return params, cfg, p32, cfg32


def swiglu_on_layers(cfg, params, batch):
    """The Bind prefill once more with llama._mlp wrapped: at each W8A8
    layer row 7 runs on that layer's MLP input and weights (as [in, out]
    views of [out, in] copies, made outside the timed region), beside the
    route (CUDA events around each; the layer's int8 weights, 135 MB, are
    not in L2), and the route's output goes on, so the path stays the
    reference's. Returns (per-layer records, the yes-probabilities)."""
    import torch
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import fused_mlp as fm
    from procyon_tpu_torch.scripts import bench_bind
    orig = llama._mlp
    layers = []

    def mlp(x, lp, c, mode, tp=None):
        if mode != "w8a8":
            return orig(x, lp, c, mode, tp)
        x2 = x.reshape(-1, x.shape[-1])
        w = [lp["mlp"][k] for k in ("w_gate", "w_up", "w_down")]
        # the layout the kernels read without a copy, made before the
        # events: a wiring of row 7 would keep the weights so
        q = [v["q"].t().contiguous().t() for v in w]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        k = fm.fused_rms_swiglu_int8(x2, lp["mlp_norm"], q[0], w[0]["s"],
                                     q[1], w[1]["s"], q[2], w[2]["s"],
                                     eps=c.norm_eps)
        ev[1].record()
        ev[2].record()
        r = orig(x, lp, c, mode, tp)
        ev[3].record()
        torch.cuda.synchronize()
        layers.append(dict(kernel_ms=ev[0].elapsed_time(ev[1]),
                           route_ms=ev[2].elapsed_time(ev[3]),
                           cos=mlp_cos(k, r.reshape(x2.shape), x2)))
        return r

    with torch.no_grad(), patched(llama, "_mlp", mlp):
        probs = bench_bind.yes_prob(params, cfg, batch)
    return layers, probs


def profile_bind_batch(params, cfg, batch, untraced_ms):
    """torch.profiler over one Bind batch (after a traced one): device busy
    and idle share, and the kernels that take most of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from procyon_tpu_torch.scripts import bench_bind

    def run():
        with torch.no_grad():
            bench_bind.yes_prob(params, cfg, batch)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  one Bind batch (W8A8) under torch.profiler: device busy "
          f"{busy:.1f} ms in {sum(e.count for e in kernels)} kernels; of "
          f"the untraced {untraced_ms:.1f} ms the device idles "
          f"{1 - busy / untraced_ms:.2f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms in "
              f"{e.count:5d} launches  {e.key[:90]}")


def phase_w8a8_prefill(dev, profile=False):
    """The slice's main path: the three W8A8 entry points at the
    reference's defaults on one decoder built once from a seed on the card
    (bench_bind.bind_config: dim 4096, 30 layers, I 11008, vocabulary
    32000; bf16, then `unified.quantize_params`): bench_prefill (weight-only
    and W8A8 tokens/s, B4 x S2048), bench_bind (pairs/s, W8A8 and
    weight-only), bench_retrieval (queries/s, 57,000 targets), each through
    its `run`; the W8A8 quality gates against bf16 on the same weights
    (bind_ce_delta and the retrieval embedding cosine, each also read with
    the flash forward's plain version in place of the kernel; the
    yes-probability gap reported; a doubled activation scale in one
    layer shown to fail them; quant_quality.probe at its default size for
    int8 W8A8, int8 and int4 weight-only); then row 7 on every layer of
    the Bind prefill (its counter zeroed just before, read just after)."""
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.evaluate import quant_quality
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.ops import fused_mlp as fm
    from procyon_tpu_torch.ops import quant
    from procyon_tpu_torch.scripts import (bench_bind, bench_prefill,
                                           bench_retrieval)
    cfg = bench_bind.bind_config()
    t0 = time.perf_counter()
    bf16 = unified.init_params(SEED + 30, cfg, device=dev)
    params = unified.quantize_params(bf16, cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in bridge.tree_leaves(params["llama"]))
    print(f"W8A8 prefill path: the bench decoder ({n / 1e9:.2f} B "
          f"parameters with scales, int8) built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    B, L = W8A8["B"], W8A8["L"]
    res = {}
    pre = bench_prefill.run(params["llama"], cfg.llama, W8A8["prefill_B"],
                            W8A8["prefill_S"], device=dev)
    check(pre["finite"], "bench_prefill: non-finite logits")
    res["prefill"] = pre["line"]
    print(f"  bench_prefill B{W8A8['prefill_B']} x S{W8A8['prefill_S']}: "
          + ", ".join(f"{m} {pre['ms'][m]:.2f} ms, "
                      f"{pre['tokens_per_sec'][m]:,.0f} tokens/s"
                      for m in bench_prefill.MODES))
    dq_cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, quant_mode="dequant"))
    fa.launches = 0
    bind = bench_bind.run(params, cfg, B, L, device=dev)
    bind_dq = bench_bind.run(params, dq_cfg, B, L, device=dev)
    check(bind["finite"] and bind_dq["finite"], "bench_bind: non-finite")
    check(fa.launches > 0 and fa.launches % cfg.llama.n_layers == 0,
          f"bench_bind: {fa.launches} flash launches")
    ret = bench_retrieval.run(params, cfg, B, L, W8A8["targets"],
                              device=dev)
    check(ret["finite"], "bench_retrieval: non-finite")
    res.update(bind=bind["line"], bind_dequant=bind_dq["line"],
               retrieval=ret["line"])
    for k in ("bind", "bind_dequant", "retrieval"):
        print(f"  {k}: {json.dumps(res[k])}")

    batch = bench_bind.bind_batch(cfg, B, L, dev)
    rbatch, targets = bench_retrieval.retrieval_batch(cfg, B, L,
                                                      W8A8["targets"], dev)

    def readout(p):
        """The Bind answer logits (f32, on the CPU) and yes-probabilities,
        and the retrieval query embeddings, of decoder p."""
        with torch.no_grad():
            at = bench_bind.answer_logits(p, cfg, batch)
            yes = torch.softmax(at[:, [bench_bind.YES_ID,
                                       bench_bind.NO_ID]], dim=-1)[:, 0]
            emb = bench_retrieval.retrieve(p, cfg, rbatch, targets)[0]
        return at.float().cpu().numpy(), yes.float(), emb.float()

    def compare(q, b):
        """(yes-probability gap, bind_ce_delta, embedding cosine min) of
        W8A8 readout q against bf16 readout b."""
        return ((q[1] - b[1]).abs().max().item(),
                quant_quality.ce_delta(b[0], q[0]),
                cosines(q[2], b[2]).min().item())

    # each reading with the flash kernel, then with the forward's plain
    # version in place of the kernel, P rounded to bf16 before P V (as the
    # kernel does) and unrounded: how far the attention's rounding alone
    # moves the numbers
    def plain(p_dtype):
        def launch(q, k, v, seg_q, seg_kv, q_pos, kv_pos, causal, sm_scale,
                   bounded, want_lse):
            out, lse = fa.flash_fwd_ref(q, k, v.to(p_dtype), seg_q, seg_kv,
                                        q_pos, kv_pos, causal=causal,
                                        sm_scale=sm_scale)
            return out, (lse if want_lse else None)
        return launch

    read_q, read_b = readout(params), readout(bf16)
    p_q = read_q[1]
    gap, ce, cos = compare(read_q, read_b)
    readings = {"kernel": (gap, ce, cos)}
    for name, p_dtype in (("plain_p_bf16", torch.bfloat16),
                          ("plain_p_f32", torch.float32)):
        with patched(fa, "_launch", plain(p_dtype)):
            readings[name] = compare(readout(params), readout(bf16))

    # the planted fault: every W8A8 product of one layer dequantizes with
    # twice its activation scale (the codes are the right ones)
    faulty_ids = {w["q"][W8A8_FAULT_LAYER].data_ptr()
                  for leaf in ("attn", "mlp")
                  for w in params["llama"]["layers"][leaf].values()
                  if quant.is_quantized(w)}
    check(len(faulty_ids) == 7, f"{len(faulty_ids)} W8A8 products a layer")
    true_qmatmul, true_rows = quant.qmatmul_w8a8, quant.quantize_rows

    def doubled_rows(x):
        xq, sx = true_rows(x)
        return xq, 2 * sx

    def faulty_qmatmul(x, qw):
        if qw["q"].data_ptr() not in faulty_ids:
            return true_qmatmul(x, qw)
        with patched(quant, "quantize_rows", doubled_rows):
            return true_qmatmul(x, qw)

    with patched(quant, "qmatmul_w8a8", faulty_qmatmul):
        fault = compare(readout(params), read_b)
    del bf16
    torch.cuda.empty_cache()
    probes = {f"int{b}_{m}": quant_quality.probe(b, m, device=dev)
              for b, m in ((8, "w8a8"), (8, "dequant"), (4, "dequant"))}
    ce_gate = quant_quality.CE_DELTA_GATES[("int8", "w8a8")]
    print(f"  W8A8 against bf16 at full width, same weights, the Bind "
          f"answer over 16 pairs and the retrieval embeddings; gated: "
          f"bind_ce_delta {ce:.5f} nats (tol {ce_gate}, the reference's "
          f"W8A8 CE-delta bound), retrieval embedding cosine min "
          f"{cos:.6f} (tol {SANITY_COS})")
    print("  with the flash forward's plain version in place of the "
          "kernel (not gated): " + ", ".join(
              f"{k}: bind_ce_delta {r[1]:.5f}, cosine {r[2]:.6f}"
              for k, r in readings.items() if k != "kernel"))
    print("  reported, not gated: the Bind yes-probability gap "
          + ", ".join(f"{k} {r[0]:.4f}" for k, r in readings.items())
          + " (a logit-space number on random weights: the reference "
          "gates none, and the attention's rounding alone moves it across "
          "0.05)")
    caught = [what for what, bad in (
        ("bind_ce_delta", fault[1] > ce_gate),
        ("retrieval embedding cosine", fault[2] < SANITY_COS)) if bad]
    print(f"  planted fault (layer {W8A8_FAULT_LAYER}'s W8A8 activation "
          f"scale doubled): bind_ce_delta {fault[1]:.5f}, cosine "
          f"{fault[2]:.6f}, yes-probability gap {fault[0]:.4f}; caught by "
          f"{', '.join(caught) if caught else 'no gated check'}")
    for k, r in probes.items():
        print(f"  quant_quality.probe {k}: {json.dumps(r.as_dict())}")
    check(ce <= ce_gate, f"W8A8 bind_ce_delta {ce} (tol {ce_gate})")
    check(cos >= SANITY_COS, f"W8A8 retrieval embedding cosine {cos}")
    check(caught, "the planted W8A8 fault passes every gated check: "
                  f"{fault}")
    for k, r in probes.items():
        check(r.passed, f"quant_quality.probe {k} failed: {r.as_dict()}")
    res["quality"] = dict(
        bind_ce_delta=ce, bind_ce_delta_gate=ce_gate,
        embedding_cos_min=cos, yes_prob_gap=gap,
        plain_attention={k: dict(zip(("yes_prob_gap", "bind_ce_delta",
                                      "embedding_cos_min"), r))
                         for k, r in readings.items() if k != "kernel"},
        fault=dict(zip(("yes_prob_gap", "bind_ce_delta",
                        "embedding_cos_min"), fault), caught_by=caught),
        probes={k: r.as_dict() for k, r in probes.items()})

    fm.launches_swiglu = 0
    layers, probs = swiglu_on_layers(cfg, params, batch)
    launches = fm.launches_swiglu
    check(launches == cfg.llama.n_layers, f"row 7 ran on {launches} of "
                                          f"{cfg.llama.n_layers} layers")
    check(torch.equal(probs.float(), p_q), "the Bind path with row 7 beside "
                                           "its MLP gave other answers")
    worst = min(r["cos"] for r in layers)
    check(worst >= QUALITY_GATE_COS, f"row 7 on the Bind layers: MLP cosine "
                                     f"{worst} to the route")
    k_ms = sum(r["kernel_ms"] for r in layers)
    r_ms = sum(r["route_ms"] for r in layers)
    print(f"  row 7 on the {len(layers)} layers of the Bind prefill (B{B} x "
          f"L{L} = {B * L} rows, each layer's own MLP input): kernel "
          f"{k_ms:.2f} ms against the W8A8 route's {r_ms:.2f} ms in all, "
          f"MLP cosine at least {worst:.6f}; the prefill took "
          f"{bind['line']['per_batch_ms']} ms a batch, so with the kernel in "
          f"the route's place it would be about "
          f"{bind['line']['per_batch_ms'] - r_ms + k_ms:.1f} ms (an "
          f"estimate, not wired)")
    print("    per layer (kernel / route ms, cosine): " + ", ".join(
        f"{r['kernel_ms']:.2f}/{r['route_ms']:.2f}/{r['cos']:.5f}"
        for r in layers))
    res["swiglu_layers"] = dict(kernel_ms=k_ms, route_ms=r_ms,
                                cos_min=worst, layers=len(layers))
    if profile:
        profile_bind_batch(params, cfg, batch, bind["line"]["per_batch_ms"])
    del params
    torch.cuda.empty_cache()
    return launches, res


def phase_qa_eval(dev, small):
    """ProcyonQAEval and run_qa_eval on the card in W8A8 on the 2-layer
    copy of phase_w8a8_small (peptide_all_qa prompts over a synthetic
    store), against the same on the CPU in f32: the yes-probabilities
    within W8A8_SMALL_PROB_ATOL and the answer logits by check_readout;
    then save_model -> load_model on the card gives the same logits, bit
    for bit."""
    import tempfile

    import numpy as np
    import torch
    from procyon_tpu_torch.data import datasets, instruct
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.evaluate.procyon_models import ProcyonQAEval
    from procyon_tpu_torch.evaluate.qa import qa_yes_prob, run_qa_eval
    from procyon_tpu_torch.inference.paged_beam import to_device
    from procyon_tpu_torch.models import checkpoint_io, unified
    params, cfg, p32, cfg32 = small
    tok = load_tokenizer(vocab_size=cfg.llama.vocab_size)
    yes, no = tok.spec.yes_id, tok.spec.no_id
    store = datasets.SyntheticStore(n_proteins=64, n_texts=64,
                                    embed_dim=cfg.protein_embed_dim)
    task = instruct.TaskLibrary().get("peptide_all_qa")
    data = [(i % 64, (7 * i) % 64, i % 2) for i in range(QA_EVAL_ROWS)]

    def logits_of(model):
        return np.concatenate([model.answer_logits(data[i:i + 8])
                               for i in range(0, len(data), 8)])

    at, probs, metrics = {}, {}, {}
    for where, p, c, d in (("card", params, cfg, dev),
                           ("cpu", p32, cfg32, "cpu")):
        model = ProcyonQAEval(p, c, tok, store, task, batch_size=8,
                              device=d)
        at[where] = logits_of(model)
        probs[where] = qa_yes_prob(at[where], yes, no)
        metrics[where] = run_qa_eval(model, data)
        if where == "card":
            collate = model.collator

            def one_early(samples, prompt):
                batch = collate(samples, prompt)
                return dict(batch, answer_pos=np.asarray(
                    batch["answer_pos"]) - 1)

            model.collator = one_early
            early = logits_of(model)
    gap = float(abs(probs["card"] - probs["cpu"]).max())
    check(gap <= W8A8_SMALL_PROB_ATOL, f"ProcyonQAEval: card and CPU "
                                       f"yes-probabilities {gap} apart")
    readout = check_readout(at["card"], at["cpu"], early, yes, no,
                            "ProcyonQAEval")
    check(set(metrics["card"]) >= {"accuracy", "f1_macro", "n"}
          and metrics["card"]["n"] == QA_EVAL_ROWS,
          f"run_qa_eval: {metrics['card']}")
    model = ProcyonQAEval(params, cfg, tok, store, task, device=dev)
    batch = to_device(model.collator(
        [(a, t, bool(y)) for a, t, y in data[:4]], model.prompt), dev)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint_io.save_model(tmp, params, cfg,
                                 tokenizer_info={"vocab_size":
                                                 cfg.llama.vocab_size})
        p2, cfg2, tok2 = checkpoint_io.load_model(tmp, device=dev)
    with torch.no_grad():
        a = unified.forward(params, cfg, batch)["logits"]
        b = unified.forward(p2, cfg2, batch)["logits"]
    check(cfg2 == cfg and tok2 is not None and torch.equal(a, b),
          "save_model -> load_model on the card changed the model")
    print(f"QA eval (ProcyonQAEval, W8A8, {W8A8_SMALL_LAYERS} layers at full "
          f"width, {QA_EVAL_ROWS} peptide_all_qa rows): card against CPU "
          f"f32 yes-probabilities within {gap:.2e} (tol "
          f"{W8A8_SMALL_PROB_ATOL}), {readout}; card yes-probabilities "
          f"{probs['card'].min():.4f} to {probs['card'].max():.4f}; "
          f"run_qa_eval card {metrics['card']}, "
          f"CPU {metrics['cpu']}; save_model -> load_model on the card: "
          "the same logits, bit for bit")
    return metrics["card"]


def eval_relations(n_proteins, seed):
    """The retrieval eval's queries (text ids 0..63), eval positives and
    train relations, drawn from a seed: 1-5 positives and RETRIEVAL_EVAL
    ["train"] train relations (leaks in the eval) a query."""
    import numpy as np
    r = RETRIEVAL_EVAL
    rng = np.random.default_rng(seed)
    queries = list(range(r["queries"]))
    ev, train = [], []
    for t in queries:
        n = int(rng.integers(*r["positives"]))
        picks = rng.choice(n_proteins, n + r["train"], replace=False)
        ev += [(int(a), t) for a in picks[:n]]
        train += [(int(a), t) for a in picks[n:]]
    return queries, ev, train


class Timed:
    """Wraps methods of an object: each call's seconds (ended by a
    synchronize) and its last result, by name."""

    def __init__(self, obj, *names):
        self.secs, self.out = {}, {}
        for name in names:
            setattr(obj, name, self._wrap(name, getattr(obj, name)))

    def _wrap(self, name, fn):
        import torch

        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.secs[name] = time.perf_counter() - t0
            self.out[name] = out
            return out
        return call


def check_retrieval_metrics(metrics, what):
    """Every metric of calc_retrieval_metrics finite and in range (the
    Fmax threshold is a cosine)."""
    for k, v in metrics.items():
        lo = -1.0 - 1e-6 if k == "fmax_threshold" else 0.0
        check(math.isfinite(v) and lo <= v <= 1.0 + 1e-6,
              f"{what}: {k} = {v}")


def phase_retrieval_eval(dev, service):
    """The evaluation slice's main path: ProcyonRetrievalEval on the
    /retrieve service's parameters, config, tokenizer and store, through
    run_retrieval_eval with the full RetrievalEvalConfig: 64 query texts of
    a disgenet retrieval task against all 20,000 proteins, eval and train
    relations from a seed (the train pairs NaN-masked as leaks). Checks the
    eval's target table against service.all_protein_embeddings, its first
    score rows against a direct retrieval_query_embedding of the same
    batch against that table, every metric, and that row 3 ran once a
    layer for each query batch. Returns (row 3's launches, results)."""
    import numpy as np
    import torch
    from procyon_tpu_torch.data import instruct
    from procyon_tpu_torch.evaluate import retrieval as ret
    from procyon_tpu_torch.evaluate.procyon_models import ProcyonRetrievalEval
    from procyon_tpu_torch.evaluate.utils import get_train_relations_for_eval
    from procyon_tpu_torch.inference import paged_beam
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import flash_attention as fa
    r = RETRIEVAL_EVAL
    lcfg = service.cfg.llama
    ids = list(service.protein_ids)
    queries, ev, train = eval_relations(len(ids), SEED + 40)
    leaks = get_train_relations_for_eval(train, queries, ids)
    model = ProcyonRetrievalEval(
        service.params, service.cfg, service.tokenizer, service.store,
        instruct.TaskLibrary().get(r["task"]), batch_size=r["batch"],
        device=dev)
    timed = Timed(model, "query_embeddings", "target_embeddings",
                  "get_predictions")
    cfg = ret.RetrievalEvalConfig()
    batches = -(-len(queries) // r["batch"])
    fa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = ret.run_retrieval_eval(
        model, None, all_protein_ids=ids, eval_relations=ev,
        query_order=queries, cfg=cfg, train_leak_pairs=leaks)
    total = time.perf_counter() - t0
    launches = fa.launches
    check(launches == batches * lcfg.n_layers,
          f"retrieval eval: row 3 launched {launches} times, expected "
          f"{batches} batches x {lcfg.n_layers} layers")
    check_retrieval_metrics(metrics, "retrieval eval")
    secs = timed.secs
    host_s = total - secs["get_predictions"]

    table = timed.out["target_embeddings"]
    ref = service.all_protein_embeddings
    table_err = float(np.abs(table - ref).max()) \
        if table.shape == ref.shape else float("inf")
    check(table_err <= 2.0 ** -8 * float(np.abs(ref).max()),
          f"retrieval eval: its target table {table.shape} is "
          f"{table_err} from the service's {ref.shape}")
    scores = timed.out["get_predictions"]
    check(scores.shape == (len(queries), len(ids))
          and np.isfinite(scores).all(), f"scores {scores.shape}")
    n = r["direct_rows"]
    # the eval's first batch, built here with its own collator and prompt
    batch = paged_beam.to_device(model.collator(
        [(0, t) for t in queries[:r["batch"]]], model.prompt), dev)
    with torch.no_grad():
        q = unified.retrieval_query_embedding(
            service.params, service.cfg, batch)[:n].float()
        t = torch.from_numpy(ref).to(dev)
        direct = (q / q.norm(dim=1, keepdim=True).clamp_min(1e-8)) @ (
            t / t.norm(dim=1, keepdim=True).clamp_min(1e-8)).T
    direct_err = float(np.abs(direct.cpu().numpy() - scores[:n]).max())
    check(direct_err <= DIRECT_SCORE_ATOL,
          f"retrieval eval: its first {n} score rows are {direct_err} from "
          f"a direct retrieval_query_embedding of the same batch")
    qps = len(queries) / secs["query_embeddings"]
    print(f"retrieval eval: ProcyonRetrievalEval + run_retrieval_eval at "
          f"ProCyon-Full ({lcfg.n_layers} layers), {len(queries)} "
          f"{r['task']} queries in {batches} batches of {r['batch']} against "
          f"{len(ids)} targets ({len(ev)} positives, {len(leaks)} train "
          f"pairs masked), top-k {cfg.top_ks}, {cfg.num_resamples} "
          f"class-balanced resamples, {cfg.n_boot} bootstrap draws: query "
          f"embeddings {secs['query_embeddings']:.3f} s ({qps:.2f} "
          f"queries/s), target sweep {secs['target_embeddings']:.3f} s, the "
          f"cosine matrix and its copy {secs['get_predictions'] - secs['query_embeddings'] - secs['target_embeddings']:.3f} s, "
          f"metrics on the host {host_s:.3f} s; row 3 launched {launches} "
          f"times ({batches} x {lcfg.n_layers}); target table against the "
          f"service's {table_err:.3g} off, {n} score rows against a direct "
          f"query embedding {direct_err:.3g} off (tol {DIRECT_SCORE_ATOL})")
    print("  metrics: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    metrics.items()))
    return launches, dict(
        queries=len(queries), targets=len(ids), queries_per_sec=qps,
        query_s=secs["query_embeddings"],
        target_sweep_s=secs["target_embeddings"],
        predictions_s=secs["get_predictions"], host_metrics_s=host_s,
        table_max_abs_err=table_err, direct_max_abs_err=direct_err,
        metrics=metrics)


def phase_retrieval_eval_small(dev):
    """ProcyonRetrievalEval on the card (bf16, the flash kernel) against
    the CPU (f32, the plain path) on the same weights: ProCyon-Full widths
    cut to 2 layers, the vocabulary cut to 8192 for this check only, 4
    queries against 512 proteins; the cosine matrices within
    RETRIEVAL_SMALL_ATOL."""
    import numpy as np
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.app.main import procyon_full_config
    from procyon_tpu_torch.data import datasets, instruct
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.evaluate.procyon_models import ProcyonRetrievalEval
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.ops import flash_attention as fa
    s = RETRIEVAL_SMALL
    full = procyon_full_config(s["layers"])
    cfg = dataclasses.replace(full, llama=dataclasses.replace(
        full.llama, vocab_size=s["vocab"]))
    params = unified.init_params(SEED + 41, cfg, device=dev)
    store = datasets.SyntheticStore(n_proteins=s["proteins"],
                                    embed_dim=cfg.protein_embed_dim)
    tok = load_tokenizer(vocab_size=s["vocab"])
    task = instruct.TaskLibrary().get(RETRIEVAL_EVAL["task"])
    queries, targets = list(range(s["queries"])), list(range(s["proteins"]))
    fa.launches = 0
    card = ProcyonRetrievalEval(
        params, cfg, tok, store, task, batch_size=s["queries"],
        device=dev).get_predictions(queries, targets)
    check(fa.launches == s["layers"],
          f"retrieval eval check: {fa.launches} flash launches on the card, "
          f"expected {s['layers']}")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                llama=dataclasses.replace(
                                    cfg.llama, dtype=torch.float32))
    p32 = bridge.to_torch(bridge.to_numpy(params), device="cpu")
    del params
    t0 = time.perf_counter()
    cpu = ProcyonRetrievalEval(
        p32, cfg32, tok, store, task, batch_size=s["queries"],
        device="cpu").get_predictions(queries, targets)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max())
    top = [len(set(np.argsort(-a)[:10]) & set(np.argsort(-b)[:10]))
           for a, b in zip(card, cpu)]
    print(f"retrieval eval check (ProCyon-Full widths, {s['layers']} "
          f"layers, vocab cut to {s['vocab']} for this check only, "
          f"{s['queries']} queries x {s['proteins']} proteins): card bf16 "
          f"vs CPU f32 cosine matrices within {err:.4f} (max abs; tol "
          f"{RETRIEVAL_SMALL_ATOL:.4f}, mean {np.abs(card - cpu).mean():.2e}"
          f"), top-10 overlap {top} (CPU run {cpu_s:.1f} s)")
    check(card.shape == cpu.shape == (s["queries"], s["proteins"])
          and np.isfinite(card).all(), f"scores {card.shape}")
    check(err <= RETRIEVAL_SMALL_ATOL,
          f"retrieval eval: card and CPU scores {err} apart")
    fault = float(np.abs(card[:, ::-1] - cpu).max())
    print(f"  the card's columns in reversed target order: {fault:.4f} "
          f"from the CPU's, beyond the tolerance")
    check(fault > RETRIEVAL_SMALL_ATOL,
          f"retrieval eval check: scores in another target order pass "
          f"({fault})")
    return err


class FirstProteins:
    """A store that holds only the first n proteins of `base` (for the
    synthetic streams, which draw relations over `n_proteins`); everything
    else is the wrapped store's."""

    def __init__(self, base, n):
        self.base, self.n_proteins = base, n

    def __getattr__(self, name):
        return getattr(self.base, name)


def phase_midtrain_eval(dev, cfg, params, store, tokenizer):
    """training/evaluation.build_midtrain_eval as run_pretrain --synthetic
    builds it: val-split go / process QA and retrieval streams over the
    store's first MIDTRAIN["targets"] proteins (run_pretrain's
    eval_max_target_proteins), which are the targets, n_batches 2; one
    eval_fn(params). The QA val loss must be finite and the retrieval AUROC
    / AUPRC in [0, 1]."""
    import torch
    from procyon_tpu_torch.data import collators, data_config
    from procyon_tpu_torch.training.evaluation import build_midtrain_eval
    m = MIDTRAIN
    store = FirstProteins(store, m["targets"])
    mix = data_config.MultiDatasetConfig(entries=[data_config.DatasetEntry(
        text_type="go", relations=["process"], tasks=["qa", "retrieval"],
        splits=["val"])])
    streams, _, _ = data_config.build_task_streams(
        mix, store=store, tokenizer=tokenizer,
        collator_cfg=collators.CollatorConfig(
            protein_embed_dim=cfg.encoder_out_dim),
        batch_sizes={"qa": m["batch"], "retrieval": m["batch"]},
        synthetic=True, seed=SEED + 42)
    eval_fn = build_midtrain_eval(
        cfg, val_streams=streams, store=store,
        all_protein_ids=list(range(m["targets"])),
        n_batches=m["n_batches"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eval_fn(params)
    secs = time.perf_counter() - t0
    check(math.isfinite(out["qa/loss"]), f"mid-train eval: {out}")
    for k in ("retrieval/auroc", "retrieval/auprc"):
        check(0.0 <= out[k] <= 1.0, f"mid-train eval: {k} = {out[k]}")
    print(f"  mid-train eval (build_midtrain_eval, {m['n_batches']} val "
          f"batches of {m['batch']} a task, {m['targets']} targets): "
          f"{secs:.2f} s; qa/loss {out['qa/loss']:.4f}, retrieval/auroc "
          f"{out['retrieval/auroc']:.4f}, retrieval/auprc "
          f"{out['retrieval/auprc']:.4f}, loss {out['loss']:.4f}")
    return dict(out, seconds=secs)


def caption_metrics(captions, store):
    """calc_caption_metrics over captions made on the card, each protein's
    store text its reference."""
    from procyon_tpu_torch.evaluate.caption import calc_caption_metrics
    t0 = time.perf_counter()
    m = calc_caption_metrics(captions, {a: [store.text(a)]
                                        for a in captions})
    secs = time.perf_counter() - t0
    check(m["n"] == len(captions)
          and all(math.isfinite(m[k]) and 0.0 <= m[k] <= 1.0
                  for k in ("rouge_l", "bleu", "rouge_l_ci_low",
                            "rouge_l_ci_high")),
          f"caption metrics: {m}")
    print(f"  caption metrics (calc_caption_metrics, the store's texts as "
          f"references): ROUGE-L {m['rouge_l']:.4f} (CI "
          f"{m['rouge_l_ci_low']:.4f}-{m['rouge_l_ci_high']:.4f}), BLEU "
          f"{m['bleu']:.4f} over {m['n']} captions in {secs * 1e3:.1f} ms "
          f"on the host")
    return m


def read_tsv(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def phase_eval_cli(dev):
    """`run_eval_framework --synthetic --device cuda` in its own process
    (ProCyon and the baselines over retrieval, QA and caption), and the
    baselines again with --device cpu: the baselines' rows equal (numpy on
    the same blobs), ProCyon's finite."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for device, models, tasks in (
                ("cuda", EVAL_CLI_MODELS, ("retrieval", "qa", "caption")),
                ("cpu", EVAL_CLI_MODELS[1:], ("retrieval", "qa"))):
            out = os.path.join(tmp, device)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "procyon_tpu_torch.scripts.run_eval_framework",
                 "--synthetic", "--device", device, "--output_dir", out,
                 "--models", *models, "--tasks", *tasks,
                 "--caption_max_len", "32"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0,
                  f"run_eval_framework --device {device} exited "
                  f"{proc.returncode}: {proc.stderr[-3000:]}")
            runs[device] = (out, time.perf_counter() - t0)
        procyon = 0
        for task in ("retrieval", "qa", "caption"):
            card = read_tsv(os.path.join(runs["cuda"][0],
                                         f"{task}_metrics.tsv"))
            check(card[0] == ["model", "dataset", "metric", "value"],
                  f"{task}_metrics.tsv header {card[0]}")
            rows = [r for r in card[1:] if r[0] == "procyon"]
            check(rows and all(math.isfinite(float(r[3])) for r in rows),
                  f"run_eval_framework: ProCyon's {task} rows {rows}")
            procyon += len(rows)
            if task != "caption":
                cpu = read_tsv(os.path.join(runs["cpu"][0],
                                            f"{task}_metrics.tsv"))
                base = [r for r in card if r[0] != "procyon"]
                check(base == cpu, f"run_eval_framework: the baselines' "
                                   f"{task} rows differ between the card "
                                   f"and the CPU runs")
    print(f"run_eval_framework --synthetic: --device cuda ({', '.join(EVAL_CLI_MODELS)}; "
          f"retrieval, qa, caption) exit 0 in {runs['cuda'][1]:.1f} s, "
          f"{procyon} ProCyon rows finite; the baselines' rows equal to a "
          f"--device cpu run's ({runs['cpu'][1]:.1f} s)")
    return dict(card_s=runs["cuda"][1], cpu_s=runs["cpu"][1],
                procyon_rows=procyon)


def bert_words(n, seed):
    """n distinct lowercase pseudo-words of 3-10 letters, sorted, from a
    seed: the synthetic WordPiece vocabulary holds each whole (one token a
    word)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < n:
        words.add("".join(rng.choice(letters, int(rng.integers(3, 11)))))
    return sorted(words)


def bert_tokenizer(vocab_size, seed):
    """The synthetic WordPiece vocabulary (specials, characters and their
    continuations, then whole words up to vocab_size) and its word list."""
    from procyon_tpu_torch.data.wordpiece import WordPieceTokenizer
    words = bert_words(BERTSCORE["words"], seed)
    tok = WordPieceTokenizer.synthetic(words=words, vocab_size=vocab_size)
    return tok, [w for w in words if w in tok.vocab]


def caption_pairs(words, n, refs_per, seed):
    """n candidates of BERTSCORE["tokens"] WordPiece tokens ([CLS] and
    [SEP] included), each with refs_per references that keep 60% of its
    words and differ in length by up to 40%."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = BERTSCORE["tokens"]
    words = np.array(words)

    def length():
        return int(rng.integers(lo - 2, hi - 1))

    cands, refs = [], []
    for _ in range(n):
        c = list(rng.choice(words, length()))
        cands.append(" ".join(c))
        rs = []
        for _ in range(refs_per):
            r = [w if rng.random() < 0.6 else str(rng.choice(words))
                 for w in c]
            k = int(np.clip(len(c) * rng.uniform(0.6, 1.4), lo - 2, hi - 2))
            r = (r + list(rng.choice(words, max(k - len(r), 0))))[:k]
            rs.append(" ".join(r))
        refs.append(rs)
    return cands, refs


def bert_hf_state(g, dev, *, vocab_size, dim, n_layers, max_position,
                  **_):
    """A BERT checkpoint's state dict in the HF layout (the `bert.` prefix,
    [out, in] weights, a pooler) drawn from a seeded generator on the
    card: weights and embeddings N(0, 0.02), LayerNorms 1 and 0, biases 0,
    f32."""
    import torch
    d, f = dim, 4 * dim

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) * 0.02

    def ones(n):
        return torch.ones(n, device=dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    s = {"embeddings.word_embeddings.weight": w(vocab_size, d),
         "embeddings.position_embeddings.weight": w(max_position, d),
         "embeddings.token_type_embeddings.weight": w(2, d),
         "embeddings.LayerNorm.weight": ones(d),
         "embeddings.LayerNorm.bias": zeros(d),
         "pooler.dense.weight": w(d, d), "pooler.dense.bias": zeros(d)}
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            s[p + f"attention.self.{name}.weight"] = w(d, d)
            s[p + f"attention.self.{name}.bias"] = zeros(d)
        s[p + "attention.output.dense.weight"] = w(d, d)
        s[p + "attention.output.dense.bias"] = zeros(d)
        s[p + "intermediate.dense.weight"] = w(f, d)
        s[p + "intermediate.dense.bias"] = zeros(f)
        s[p + "output.dense.weight"] = w(d, f)
        s[p + "output.dense.bias"] = zeros(d)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            s[p + ln + ".weight"] = ones(d)
            s[p + ln + ".bias"] = zeros(d)
    return {"bert." + k: v for k, v in s.items()}


def bertscore_errors(a, b):
    """The largest |difference| of P, R and F1 between two results."""
    import numpy as np
    return max(float(np.abs(getattr(a, k) - getattr(b, k)).max())
               for k in ("precision", "recall", "f1"))


def check_scores(res, what):
    import numpy as np
    for k in ("precision", "recall", "f1"):
        x = getattr(res, k)
        check(np.isfinite(x).all() and (np.abs(x) <= 1 + 1e-6).all(),
              f"{what}: {k} not finite or outside [-1, 1]: "
              f"{x.min()}..{x.max()}")


def attend_padding(forward):
    """bert.forward with every key live (seg ids of ones): a planted fault
    of the encoder's padding mask."""
    import torch

    def run(params, cfg, tokens, **kw):
        kw["seg_ids"] = torch.ones_like(tokens, dtype=torch.int32)
        return forward(params, cfg, tokens, **kw)
    return run


def phase_bertscore_small(dev, state, tok, words):
    """The 2-layer copy of the SciBERT-width scorer (the state's first two
    layers, scoring layer 2) on the card in bf16 against the CPU in f32 on
    BERTSCORE_SMALL["pairs"] pairs: P, R and F1 within
    BERTSCORE_SMALL_ATOL; the references in reverse order, pad keys
    attended and layer 1 read must each fail it."""
    import torch
    from procyon_tpu_torch.evaluate import bertscore as bs
    from procyon_tpu_torch.models import bert
    n = BERTSCORE_SMALL["layers"]
    small = {k: v for k, v in state.items()
             if not k.startswith("bert.encoder.layer.")
             or int(k.split(".")[3]) < n}
    cands, refs = caption_pairs(words, BERTSCORE_SMALL["pairs"], 1,
                                SEED + 51)
    refs = [r[0] for r in refs]
    out, faults = {}, {}
    for where, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
        params, cfg = bert.convert_hf_state(
            {k: v.to(where) for k, v in small.items()}, dtype=dtype,
            device=where)
        scorer = bs.BERTScorer(params, cfg, tok, layer=n,
                               batch_size=BERTSCORE["batch"])
        out[str(where)] = scorer.score(cands, refs)
        if where == dev:
            faults["references reversed"] = scorer.score(cands, refs[::-1])
            with patched(bert, "forward", attend_padding(bert.forward)):
                faults["pad keys attended"] = scorer.score(cands, refs)
            scorer.layer = n - 1
            faults[f"layer {n - 1} read"] = scorer.score(cands, refs)
    cpu = out["cpu"]
    card = out[str(dev)]
    check_scores(card, "BERTScore 2-layer card")
    err = bertscore_errors(card, cpu)
    check(err <= BERTSCORE_SMALL_ATOL,
          f"BERTScore 2-layer: card {err} from the CPU "
          f"(> {BERTSCORE_SMALL_ATOL})")
    fault_errs = {k: bertscore_errors(f, cpu) for k, f in faults.items()}
    for k, e in fault_errs.items():
        check(e > BERTSCORE_SMALL_ATOL,
              f"BERTScore 2-layer: the fault '{k}' passes the check ({e})")
    print(f"BERTScore 2-layer check ({len(cands)} pairs, SciBERT width, "
          f"layer {n}): card bf16 against CPU f32 max |dP|,|dR|,|dF1| "
          f"{err:.3e} (tol {BERTSCORE_SMALL_ATOL}); planted faults, each "
          f"failing it: "
          + ", ".join(f"{k} {e:.3e}" for k, e in fault_errs.items())
          + f"; F1 {float(cpu.f1.mean()):.4f} mean on the CPU")
    return dict(max_abs_err=err, fault_errs=fault_errs)


def phase_bertscore(dev, profile=False):
    """BERTScore at SciBERT-base width (the en-sci scorer): the checkpoint
    built as an HF state dict from a seed and loaded through
    convert_hf_state, layer 8, the synthetic WordPiece vocabulary; 512
    candidates x 3 references in chunks of 64 pairs, idf off and on, then
    a baseline from compute_baseline over 1,000 pairs applied; with
    profile, one encoder call on the first chunk's texts traced. Returns
    (row 3's launches, results); the launch count is this path's alone."""
    import numpy as np
    import torch
    from procyon_tpu_torch.evaluate import bertscore as bs
    from procyon_tpu_torch.models import bert
    from procyon_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    state = bert_hf_state(g, dev, **SCIBERT)
    tok, words = bert_tokenizer(SCIBERT["vocab_size"], SEED + 50)
    small = phase_bertscore_small(dev, state, tok, words)
    params, cfg = bert.convert_hf_state(state, dtype=torch.bfloat16,
                                        device=dev)
    del state
    check(cfg == bert.BertConfig(**SCIBERT),
          f"convert_hf_state read {cfg}")
    scorer = bs.BERTScorer(params, cfg, tok, layer=BERTSCORE["layer"],
                           batch_size=BERTSCORE["batch"])
    cands, refs = caption_pairs(words, BERTSCORE["candidates"],
                                BERTSCORE["refs"], SEED + 52)
    lengths = [len(tok.encode(t, max_len=512)) for rs in refs for t in rs]
    lengths += [len(tok.encode(t, max_len=512)) for t in cands]
    scorer.score(cands[:64], refs[:64])          # warm-up
    torch.cuda.synchronize()
    fa.launches = 0
    runs = {}
    for idf in (False, True):
        scorer.idf = idf
        res = scorer.score(cands, refs)
        check_scores(res, f"BERTScore idf={idf}")
        runs[f"idf_{idf}".lower()] = dict(scorer.last_timing,
                                          f1=float(res.f1.mean()))
    scorer.idf = False
    t0 = time.perf_counter()
    baseline = bs.compute_baseline(scorer, [r for rs in refs for r in rs],
                                   n_pairs=BERTSCORE["baseline_pairs"],
                                   seed=SEED)
    baseline_s = time.perf_counter() - t0
    calls = sum(r["encoder_calls"] for r in runs.values()) \
        + scorer.last_timing["encoder_calls"]
    scorer.baseline = baseline
    rescaled = scorer.score(cands, refs)
    calls += scorer.last_timing["encoder_calls"]
    for k in ("precision", "recall", "f1"):
        check(np.isfinite(getattr(rescaled, k)).all(),
              f"BERTScore rescaled {k} not finite")
    launches = fa.launches
    check(launches == calls * BERTSCORE["layer"],
          f"BERTScore: row 3 launched {launches} times, expected "
          f"{calls} encoder calls x {BERTSCORE['layer']} layers")
    pairs = len(cands) * BERTSCORE["refs"]
    for key, r in runs.items():
        r["pairs_per_sec"] = r["pairs"] / r["seconds"]
        r["encoder_share"] = r["encoder_seconds"] / r["seconds"]
    if profile:
        texts = list(dict.fromkeys(t for c, rs in zip(cands, refs)
                                   for t in [c] + rs))[:86]
        ids = torch.from_numpy(tok.batch_encode(texts).ids).to(dev)
        call = functools.partial(bs.embed_layer, params, cfg, ids,
                                 BERTSCORE["layer"])
        profile_once(f"one BERTScore encoder call ({tuple(ids.shape)} "
                     f"tokens, {BERTSCORE['layer']} layers)", call,
                     cuda_ms(call, iters=3))
    print(f"BERTScore at SciBERT-base width (vocab {cfg.vocab_size}, "
          f"{cfg.n_layers} layers, layer {scorer.layer} read, bf16): "
          f"{len(cands)} candidates x {BERTSCORE['refs']} references = "
          f"{pairs} pairs in chunks of {BERTSCORE['batch']}, texts of "
          f"{min(lengths)}-{max(lengths)} tokens (median "
          f"{int(np.median(lengths))}): "
          + "; ".join(f"{k} {r['pairs_per_sec']:.1f} pairs/s "
                      f"({r['seconds']:.3f} s, encoder "
                      f"{100 * r['encoder_share']:.1f}%, F1 {r['f1']:.4f})"
                      for k, r in runs.items())
          + f"; baseline over {BERTSCORE['baseline_pairs']} pairs "
          f"{tuple(round(b, 4) for b in baseline)} in {baseline_s:.3f} s, "
          f"rescaled F1 {float(rescaled.f1.mean()):.4f}; row 3 launched "
          f"{launches} times ({calls} encoder calls x "
          f"{BERTSCORE['layer']} layers)")
    return launches, dict(pairs=pairs, runs=runs, baseline=baseline,
                          baseline_s=baseline_s, small_check=small,
                          rescaled_f1=float(rescaled.f1.mean()))


def phase_bert_flash(dev):
    """Row 3 at BERT's shape, bidirectional, right-padded to lengths drawn
    as BERTScore's texts (30-400 tokens) and a quarter of the rows full:
    flash_case's checks and times (the plain version, sdpa with the same
    key mask beside it)."""
    import numpy as np
    import torch
    B, S, H, D = (BERT_FLASH[k] for k in ("B", "S", "H", "D"))
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    rng = np.random.default_rng(SEED + 53)
    lens = rng.integers(*BERTSCORE["tokens"], B)
    lens[rng.random(B) < 0.25] = S
    seg = (torch.arange(S, device=dev)[None]
           < torch.from_numpy(lens).to(dev)[:, None]).to(torch.int32)
    entry = flash_case("bert_fwd", q, k, v, seg, seg, causal=False)
    entry["live_tokens"] = int(lens.sum())
    return entry


def baseline_datasets():
    """The synthetic store and the retrieval and QA datasets of the text
    baselines: BASELINE_STORE's proteins, 64 query texts with 1-5
    positives each (train relations masked as leaks), 64 QA pairs, half of
    them positives."""
    import numpy as np
    from procyon_tpu_torch.data import datasets as D
    from procyon_tpu_torch.evaluate.utils import get_train_relations_for_eval
    b = BASELINE_STORE
    store = D.SyntheticStore(n_proteins=b["proteins"], n_texts=b["queries"],
                             embed_dim=32, seed=SEED + 60,
                             min_len=b["min_len"], max_len=b["max_len"])
    ids = list(range(b["proteins"]))
    queries, ev, train = eval_relations(b["proteins"], SEED + 61)
    rng = np.random.default_rng(SEED + 62)
    pos = [ev[i] for i in rng.choice(len(ev), b["qa"] // 2, replace=False)]
    neg = [(int(rng.integers(b["proteins"])), int(rng.integers(
        b["queries"]))) for _ in range(b["qa"] - len(pos))]
    qa = [(a, t, 1) for a, t in pos] + [(a, t, 0) for a, t in neg]
    return store, {
        "baseline_retrieval": {
            "task": "retrieval", "eval_relations": ev,
            "query_order": queries, "all_protein_ids": ids, "store": store,
            "train_leak_pairs": get_train_relations_for_eval(
                train, queries, ids)},
        "baseline_qa": {"task": "qa", "qa_samples": qa, "store": store}}


def baseline_context(name, dev, g, store, layers=None):
    """The model context for one text baseline, its towers at full width
    built from the generator g on the card (bf16); layers cuts BERT, ESM2
    and Llama to that depth (the CNN has none)."""
    import torch
    from procyon_tpu_torch.data.text_tokenizer import WordTokenizer
    from procyon_tpu_torch.evaluate.baselines import text_models as tm
    from procyon_tpu_torch.evaluate.baselines.protllm import ProtLLMConfig
    from procyon_tpu_torch.models import bert, esm2, llama
    bf16 = torch.bfloat16
    cut = {} if layers is None else {"n_layers": layers}

    def pubmedbert(pooler, proj=None, **kw):
        cfg = bert.BertConfig(**dict(PUBMEDBERT, **cut))
        tok, _ = bert_tokenizer(cfg.vocab_size, SEED + 63)
        return tm.BertTextTower(bert.init_params(g, cfg, device=dev), cfg,
                                tok, pooler=pooler, proj=proj, **kw)

    def esm650m():
        cfg = esm2.esm2_config("650m", dtype=bf16, **cut)
        return esm2.init_params(g, cfg, device=dev), cfg

    if name in ("pubmedbert", "simcse"):
        return {name: {"tower": pubmedbert(
            "mean" if name == "pubmedbert" else "cls", batch_size=64)},
            "protein_text_fn": lambda a: store.text_variant(a, a)}
    if name == "biotranslator":
        ccfg = tm.CNNConfig()
        return {name: {
            "text_tower": pubmedbert("cls", tm.init_mlp_proj(
                g, PUBMEDBERT["dim"], ccfg.hidden_dim, kind="mlp",
                device=dev), batch_size=64),
            "cnn_params": tm.init_cnn_params(g, ccfg, device=dev,
                                             dtype=bf16),
            "cnn_cfg": ccfg, "kw": {"batch_size": 32}}}
    if name == "protst":
        eparams, ecfg = esm650m()
        return {name: {
            "text_tower": pubmedbert(
                "mean", tm.init_mlp_proj(g, PUBMEDBERT["dim"], 512,
                                         kind="tower_mlp", device=dev),
                batch_size=64, exclude_special_from_mean=True),
            "esm_params": eparams, "esm_cfg": ecfg,
            "graph_proj": tm.init_mlp_proj(g, ecfg.dim, 512,
                                           kind="tower_mlp", device=dev),
            "kw": {"batch_size": 32}}}
    eparams, ecfg = esm650m()
    lcfg = llama.llama2_7b(dtype=bf16, **cut)
    return {name: {
        "esm_params": eparams, "esm_cfg": ecfg,
        "llama_params": llama.init_params(g, lcfg, device=dev),
        "llama_cfg": lcfg,
        "projector": torch.randn((ecfg.dim, lcfg.dim), generator=g,
                                 device=dev) / ecfg.dim ** 0.5,
        "tokenizer": WordTokenizer(vocab_size=lcfg.vocab_size),
        "kw": {"cfg": ProtLLMConfig(max_protein_len=BASELINE_STORE[
            "max_len"])}}}


def cpu_f32(x):
    """A copy of a model context on the CPU: floating tensors in f32,
    configs' floating dtypes f32, text towers and dataclasses field by
    field; integer tensors moved as they are, other objects kept."""
    import copy
    import dataclasses
    import torch
    from procyon_tpu_torch.evaluate.baselines import text_models as tm
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float() if x.is_floating_point() \
            else x.cpu()
    if isinstance(x, torch.dtype):
        return torch.float32 if x.is_floating_point else x
    if isinstance(x, dict):
        return {k: cpu_f32(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cpu_f32(v) for v in x)
    if isinstance(x, tm.BertTextTower):
        y = copy.copy(x)
        vars(y).update({k: cpu_f32(v) for k, v in vars(x).items()})
        return y
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: cpu_f32(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def baseline_scores(name, ctx, datasets):
    """The baseline's scores through its zoo entry: a [queries, targets]
    cosine matrix, or the QA pairs' yes-probabilities."""
    from procyon_tpu_torch.evaluate import core
    core._default_zoo()
    task = "qa" if name == "protllm" else "retrieval"
    ds = datasets[f"baseline_small_{task}"]
    model = core.MODEL_ZOO[task][name](ctx, ds)
    if task == "qa":
        return model.get_predictions(ds["qa_samples"])[0]
    return model.get_predictions(ds["query_order"], ds["all_protein_ids"],
                                 dataset=ds)


def phase_text_baselines_small(dev, store, datasets):
    """Each baseline at BASELINE_SMALL's depth on the card (bf16) against
    its CPU copy (f32) on the same weights and inputs: max |d score|
    within its BASELINE_SMALL_ATOL; ProtLLM's protein spliced into the wrong
    row (the BOS row, by a tokenizer whose <|protein|> id is the BOS id)
    must fail it. Launches made here are not counted."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    b = BASELINE_SMALL
    ret, qa = datasets["baseline_retrieval"], datasets["baseline_qa"]
    small = {
        "baseline_small_retrieval": dict(
            ret, query_order=ret["query_order"][:b["queries"]],
            all_protein_ids=ret["all_protein_ids"][:b["targets"]]),
        "baseline_small_qa": dict(qa, qa_samples=qa["qa_samples"][:b["qa"]])}
    g = torch.Generator(device=dev).manual_seed(SEED + 65)
    errs, fault_err = {}, None
    for name in BASELINE_MODELS:
        ctx = baseline_context(name, dev, g, store, layers=b["layers"])
        t0 = time.perf_counter()
        card = baseline_scores(name, ctx, small)
        cpu = baseline_scores(name, cpu_f32(ctx), small)
        secs = time.perf_counter() - t0
        check(np.isfinite(card).all() and card.shape == cpu.shape,
              f"{name} {b['layers']}-layer: card scores {card.shape} "
              f"not finite or not the CPU's {cpu.shape}")
        tol = BASELINE_SMALL_ATOL[name]
        errs[name] = float(np.abs(card - cpu).max())
        check(errs[name] <= tol,
              f"{name} {b['layers']}-layer: card {errs[name]} from the "
              f"CPU (> {tol})")
        if name == "protllm":
            tok = copy.copy(ctx[name]["tokenizer"])
            tok.spec = dataclasses.replace(tok.spec,
                                           protein_id=tok.spec.bos_id)
            bad = {name: dict(ctx[name], tokenizer=tok)}
            fault_err = float(np.abs(baseline_scores(name, bad, small)
                                     - cpu).max())
            check(fault_err > tol,
                  f"protllm {b['layers']}-layer: the protein spliced into "
                  f"the BOS row passes the check ({fault_err})")
        print(f"{name} {b['layers']}-layer check: card bf16 against CPU "
              f"f32 max |d score| {errs[name]:.3e} over "
              f"{card.size} scores (tol {tol}; "
              f"{secs:.1f} s)"
              + (f"; the protein spliced into the BOS row: "
                 f"{fault_err:.3e}, fails it" if name == "protllm" else ""))
        del ctx
    torch.cuda.empty_cache()
    return dict(max_abs_err=errs, protllm_fault_err=fault_err)


def phase_text_baselines(dev):
    """The five baselines' 2-layer check against the CPU, then the five
    through run_evaluation, each with its
    towers at full width preloaded in the context and deleted before the
    next: every metric finite; queries/s (retrieval) or pairs/s (QA), peak
    device memory (and its part above what was allocated before the
    model). Returns (row 3's launches, results)."""
    import tempfile
    import torch
    from procyon_tpu_torch.evaluate import core
    from procyon_tpu_torch.ops import flash_attention as fa
    store, datasets = baseline_datasets()
    results = {"small_check": phase_text_baselines_small(dev, store,
                                                          datasets)}
    g = torch.Generator(device=dev).manual_seed(SEED + 64)
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in BASELINE_MODELS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev) / 2 ** 30
            t0 = time.perf_counter()
            ctx = baseline_context(name, dev, g, store)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            task = "qa" if name == "protllm" else "retrieval"
            args = core.EvalArgs(tasks=(task,), models=(name,),
                                 output_dir=os.path.join(tmp, name))
            fa.launches = 0
            t0 = time.perf_counter()
            (r,) = core.run_evaluation(args, datasets, model_context=ctx)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches += fa.launches
            check(fa.launches > 0, f"{name}: row 3 was not launched")
            bad = {k: v for k, v in r["metrics"].items()
                   if not math.isfinite(v)}
            check(not bad, f"{name}: metrics not finite: {bad}")
            n = BASELINE_STORE["queries" if task == "retrieval" else "qa"]
            unit = "queries" if task == "retrieval" else "pairs"
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            results[name] = {f"{unit}_per_sec": n / secs, "seconds": secs,
                             "build_s": build_s, "peak_gib": peak,
                             "own_peak_gib": peak - held,
                             "row3_launches": fa.launches,
                             "metrics": r["metrics"]}
            head = ("auroc", "auprc") if task == "retrieval" \
                else ("accuracy", "f1_macro")
            print(f"{name} ({task}, {n} {unit} over "
                  f"{BASELINE_STORE['proteins']} proteins): "
                  f"{n / secs:.2f} {unit}/s ({secs:.2f} s; towers built in "
                  f"{build_s:.1f} s), peak {peak:.1f} GiB ({peak - held:.1f} "
                  f"above the {held:.1f} held before it), row 3 launched "
                  f"{fa.launches} times; "
                  + ", ".join(f"{k} {r['metrics'][k]:.4f}" for k in head))
            del ctx
    torch.cuda.empty_cache()
    return launches, results


def phase_bert_clis(dev):
    """`run_eval_framework --synthetic --use_bertscore --device cuda` (the
    ProCyon captions with BERTScore from the synthetic scorer on the card)
    and `compute_bertscore_baseline --synthetic --device cuda`, in this
    process through their main: the BERTScore rows and the constants
    finite."""
    import tempfile
    from procyon_tpu_torch.scripts import compute_bertscore_baseline
    from procyon_tpu_torch.scripts import run_eval_framework
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = run_eval_framework.main([
            "--synthetic", "--device", "cuda", "--tasks", "caption",
            "--models", "procyon", "--caption_max_len", "16",
            "--use_bertscore", "--output_dir", tmp])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"run_eval_framework --use_bertscore returned {rc}")
        rows = {r[2]: float(r[3]) for r in read_tsv(
            os.path.join(tmp, "caption_metrics.tsv"))[1:]}
        keys = ("bertscore_f1", "bertscore_precision", "bertscore_recall")
        check(all(math.isfinite(rows.get(k, float("nan"))) for k in keys),
              f"run_eval_framework --use_bertscore: {rows}")
        t0 = time.perf_counter()
        rec = compute_bertscore_baseline.main([
            "--synthetic", "--device", "cuda", "--out",
            os.path.join(tmp, "baseline.json")])
        base_s = time.perf_counter() - t0
    check(all(math.isfinite(rec[k]) for k in ("precision", "recall", "f1")),
          f"compute_bertscore_baseline: {rec}")
    print(f"run_eval_framework --synthetic --use_bertscore --device cuda: "
          f"exit 0 in {cli_s:.1f} s, "
          + ", ".join(f"{k} {rows[k]:.4f}" for k in keys)
          + f"; compute_bertscore_baseline --synthetic: "
          f"({rec['precision']:.4f}, {rec['recall']:.4f}, {rec['f1']:.4f}) "
          f"over {rec['n_pairs']} pairs in {base_s:.1f} s")
    return dict(run_eval_framework={k: rows[k] for k in keys},
                run_eval_framework_s=cli_s, baseline=rec, baseline_s=base_s)


def run_bert_group(dev, profile=False):
    """The BERT slice: row 3 at BERT's shape (not counted), then its main
    path with row 3's count set to 0 before it and read after it
    (BERTScore at SciBERT width, the five text baselines; their checks
    against the CPU come before the count is set), then the two
    CLIs. Returns (the main path's row 3 launches, row 3's entry at BERT's
    shape, results)."""
    entry = phase_bert_flash(dev)
    launches, score = phase_bertscore(dev, profile)
    more, baselines = phase_text_baselines(dev)
    clis = phase_bert_clis(dev)
    return launches + more, entry, dict(bertscore=score,
                                        text_baselines=baselines, clis=clis)


def run_eval_group(dev, profile):
    """--only=eval: the evaluation slice's phases alone."""
    small = phase_retrieval_eval_small(dev)
    cli = phase_eval_cli(dev)
    service = synthetic_service(dev)
    launches, ret = phase_retrieval_eval(dev, service)
    mid = phase_midtrain_eval(dev, service.cfg, service.params,
                              service.store, service.tokenizer)
    _, caption = phase_caption(dev, service, profile)
    return dict(retrieval_eval=ret, flash_launches=launches,
                small_max_abs_err=small, cli=cli, midtrain_eval=mid,
                caption_metrics=caption["caption_metrics"])


# ---------------------------------------------------------------------------
# The live-encoder slice (slice 1 remainder): ESM2-3B fine-tuned with
# MoLoRA banks under LoRA phase training, the MLM task, serving the merged
# encoder, rows 3, 8 and 9 at ESM2's shapes, the native data path
# ---------------------------------------------------------------------------


def esm_sequences(n, seed):
    """n synthetic proteins: lengths drawn from ESM_DATA's range, about
    ESM_DATA["long"] of them longer than the encoder's 1024 residues (the
    MLM stream truncates them), residues uniform over the 20 amino acids."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = ESM_DATA["lengths"]
    lengths = rng.integers(lo, hi + 1, n)
    long = rng.random(n) < ESM_DATA["long"]
    lengths[long] = rng.integers(hi + 1, 2 * hi + 1, int(long.sum()))
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    flat = aa[rng.integers(0, 20, int(lengths.sum()))].tobytes().decode()
    ends = np.cumsum(lengths)
    return [flat[e - n_:e] for e, n_ in zip(ends, lengths)]


def phase_esm_data(tmp):
    """The native data path: a FASTA of ESM_DATA["proteins"] synthetic
    proteins in a DATA_DIR layout under `tmp`, ProCyonDataStore reading it
    through native.FastaIndex (the index's build seconds, sequences read a
    second over random ids, each against the sequence written). Fails if
    the native library did not build. Returns (the store, the numbers)."""
    import numpy as np
    from procyon_tpu_torch import native
    from procyon_tpu_torch.data import datasets
    t0 = time.perf_counter()
    check(native.available(), "the native library did not build (g++)")
    build_s = time.perf_counter() - t0
    seqs = esm_sequences(ESM_DATA["proteins"], SEED + 61)
    d = os.path.join(tmp, "integrated_data", "v1", "protein")
    os.makedirs(d)
    path = os.path.join(d, "protein_sequences.fa")
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">synthetic_{i} protein {i}\n")
            f.write("\n".join(s[j:j + 60] for j in range(0, len(s), 60)))
            f.write("\n")
    store = datasets.ProCyonDataStore(tmp)
    t0 = time.perf_counter()
    store._load_sequences()
    index_s = time.perf_counter() - t0
    check(isinstance(store._seqs, native.FastaIndex)
          and store._seqs._native and len(store._seqs) == len(seqs),
          "ProCyonDataStore did not index the FASTA natively")
    ids = np.random.default_rng(SEED + 62).integers(0, len(seqs),
                                                    ESM_DATA["reads"])
    t0 = time.perf_counter()
    got = [store.protein_sequence(int(i)) for i in ids]
    read_s = time.perf_counter() - t0
    check(all(g == seqs[i] for g, i in zip(got, ids)),
          "a sequence read through the index differs from the one written")
    out = dict(proteins=len(seqs), fasta_mb=os.path.getsize(path) / 1e6,
               native_build_s=build_s, index_build_s=index_s,
               sequences_read_per_s=len(ids) / read_s,
               residues=int(sum(len(s) for s in seqs)))
    print(f"native data path: {len(seqs)} proteins "
          f"({out['fasta_mb']:.1f} MB of FASTA, lengths "
          f"{ESM_DATA['lengths']} with {ESM_DATA['long']:.0%} longer); "
          f"library {build_s:.2f} s (g++ at first use), index "
          f"{index_s:.3f} s, {out['sequences_read_per_s']:.0f} sequences "
          f"read a second (host clock, {len(ids)} random ids), each the "
          "sequence written")
    return store, out


def esm_config(**kw):
    """ESM2-3B (ProCyon-Full's encoder) with the slice's MoLoRA banks, in
    bf16, remat on."""
    import torch
    from procyon_tpu_torch.models import esm2, lora
    base = dict(dtype=torch.bfloat16, lora=lora.LoRAConfig(
        rank=ESM_TRAIN["lora_rank"], alpha=ESM_TRAIN["lora_alpha"],
        num_experts=ESM_TRAIN["experts"], dtype=torch.bfloat16),
        lora_targets=ESM_TRAIN["targets"])
    base.update(kw)
    return esm2.esm2_config("3b", **base)


def esm_tokens(seqs, max_len, width=None):
    """ESM token rows [len(seqs), width] of proteins truncated to max_len
    residues (native.batch_encode), right-padded to `width`."""
    import numpy as np
    from procyon_tpu_torch import native
    from procyon_tpu_torch.data.protein_tokenizer import PAD_IDX
    pb = native.batch_encode(seqs, max_len=max_len, long_strategy="truncate")
    if width is None or pb.tokens.shape[1] == width:
        return pb.tokens
    out = np.full((len(seqs), width), PAD_IDX, np.int32)
    out[:, :pb.tokens.shape[1]] = pb.tokens
    return out


def esm_train_flops_per_token(ecfg, seq):
    """train_flops_per_token's count for the encoder under LoRA: matmul
    weights P (the layers, the LM head's dense and its tied decoder);
    forward 2P, dL/dx 2P, remat's recompute 2P (dL/dW only for the banks,
    left out as the decoder's count leaves out its LoRA); attention 2 * 2 *
    S * d a token and layer, bidirectional (not halved), in the forward,
    the backward and the recompute."""
    d, L = ecfg.dim, ecfg.n_layers
    P = L * (4 * d * d + 2 * d * ecfg.ffn_dim) + d * d + d * ecfg.vocab_size
    return 6 * P + 3 * 4 * seq * d * L


def phase_esm_train(dev, service, store, profile=False):
    """A. LoRA phase training with a live ESM2-3B encoder at ProCyon-Full
    width: the /retrieve service's decoder quantized to int8 with LoRA
    r16 x 4 (phase_train's), ESM2-3B in bf16 with MoLoRA banks on its six
    projections, the projectors and the temperature trained; run_pretrain's
    freeze mask (freeze_fn) and Trainer(lora_phase_training=True). A
    global step: qa on expert 0 (B2 x S2048, its 8 proteins encoded
    live), retrieval on 1 (the same batch, phase_train's), mlm on 2 (8
    proteins x 1024 residues from the FASTA store, masked natively), then
    the joint step on 3 over all three. 2 warm and 4 timed global steps;
    ms a phase and a global step, the MLM step's tokens/s and MFU, peak
    memory, launches of rows 3, 8 and 9 and of the GELU pair (csrc/
    gelu_erf.cu, at least one a layer of each ESM2 pass) a phase, their
    counts set to 0 before the steps. Returns (launches, the
    trained encoder's tree and config, results)."""
    import tempfile

    import torch
    from procyon_tpu_torch import config as tconfig
    from procyon_tpu_torch.data import data_config
    from procyon_tpu_torch.models import esm2
    from procyon_tpu_torch.ops import activations as act
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.scripts import bench_train
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    from procyon_tpu_torch.training.trainer import Trainer, TrainLoopConfig
    t = ESM_TRAIN
    ecfg = esm_config()
    cfg = dataclasses.replace(bench_train.qlora_config(service.cfg), esm=ecfg)
    check(cfg.encoder_out_dim == service.cfg.protein_embed_dim,
          "the service's projectors do not take ESM2-3B's width")
    g = torch.Generator(device=dev).manual_seed(SEED + 63)
    t0 = time.perf_counter()
    params = dict(bench_train.qlora_params(service.params, cfg, g),
                  esm=esm2.init_params(SEED + 63, ecfg, device=dev))
    torch.cuda.synchronize()
    n_enc = sum(x.numel() for path, x in topt.tree_items(params["esm"])
                if not any(k.startswith("lora_") for k in path))
    margs = tconfig.ModelArgs(use_aaseq_embeddings=False, use_lora=True,
                              use_prot_lora=True)
    opt = topt.build_frozen_mask_optimizer(
        topt.OptimizerConfig(lr=t["lr"], warmup_steps=t["warmup"],
                             total_steps=1000), tconfig.freeze_fn(margs))
    lcfg = cfg.llama
    qa = ts.batch_to_device(bench_train.train_batch(
        TRAIN["B"], TRAIN["S"], lcfg.vocab_size, cfg.protein_embed_dim,
        SEED + 35), dev)
    del qa["protein_embeds"]
    U = TRAIN["soft_tokens"]
    qa["protein_tokens"] = torch.from_numpy(esm_tokens(
        [store.protein_sequence(i) for i in range(U)], t["max_len"])).to(dev)
    stream = data_config.build_mlm_stream(
        store, batch_size=t["mlm_batch"], n_proteins=ESM_DATA["proteins"],
        max_protein_len=t["max_len"], seed=SEED + 64)
    n_steps = t["warm"] + t["timed"]
    mlm = [ts.batch_to_device(stream(), dev) for _ in range(2 * n_steps)]
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(cfg=cfg, params=params, optimizer=opt,
                          loop=TrainLoopConfig(max_steps=n_steps,
                                               output_dir=out_dir,
                                               lora_phase_training=True),
                          task_streams={"qa": None, "retrieval": None,
                                        "mlm": None})
        trainer.metrics.close()
    del params
    n_train = sum(x.numel() for _, x in opt.trainable_items(
        trainer.state["params"]))
    print(f"live-encoder training: Llama-3-8B int8 + LoRA "
          f"r{TRAIN['lora_rank']}x{TRAIN['lora_experts']}, ESM2-3B bf16 "
          f"({ecfg.n_layers} layers, d {ecfg.dim}, H{ecfg.n_heads} "
          f"D{ecfg.head_dim}, {n_enc / 1e9:.2f} B parameters) + MoLoRA "
          f"r{t['lora_rank']}x{t['experts']} on {ecfg.lora_targets}; "
          f"{n_train / 1e6:.1f} M trainable parameters; built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card "
          "with the service's bf16 weights")
    widths = sorted({int(b["protein_tokens"].shape[1]) for b in mlm})
    masked = sum(int((b["mlm_labels"] != -100).sum()) for b in mlm)
    print(f"  MLM batches: {t['mlm_batch']} proteins, widths {widths}, "
          f"{masked / len(mlm):.0f} masked residues a batch")
    expect = {
        "qa": 2 * (lcfg.n_layers + ecfg.n_layers),
        "retrieval": 2 * (lcfg.n_layers + ecfg.n_layers),
        "mlm": 2 * ecfg.n_layers,
        "joint": 2 * (2 * lcfg.n_layers + 3 * ecfg.n_layers)}
    counts = ("launches", "launches_bwd_dq", "launches_bwd_dkv")
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    act.launches = act.launches_bwd = 0
    esm_passes = {"qa": 1, "retrieval": 1, "mlm": 1, "joint": 3}
    torch.cuda.reset_peak_memory_stats(dev)
    times = {k: [] for k in ("qa", "retrieval", "mlm", "joint", "global")}
    per, gelu_per, first, last = {}, {}, {}, {}
    for step in range(n_steps):
        batches = {"qa": qa, "retrieval": qa, "mlm": mlm[2 * step]}
        joint_batches = {"qa": qa, "retrieval": qa, "mlm": mlm[2 * step + 1]}
        torch.cuda.synchronize()
        g0 = time.perf_counter()
        for phase in ("qa", "retrieval", "mlm", "joint"):
            before = [getattr(fa, c) for c in counts]
            gelu_before = (act.launches, act.launches_bwd)
            p0 = time.perf_counter()
            if phase == "joint":
                trainer.state, m = trainer.joint_step(trainer.state,
                                                      joint_batches)
            else:
                trainer.state, m = trainer.steps[phase](trainer.state,
                                                        batches[phase])
            loss = float(m["loss"])
            ms = (time.perf_counter() - p0) * 1e3
            per[phase] = [getattr(fa, c) - b for c, b in zip(counts, before)]
            gelu_per[phase] = [act.launches - gelu_before[0],
                               act.launches_bwd - gelu_before[1]]
            check(math.isfinite(loss), f"{phase} loss {loss}")
            first.setdefault(phase, loss)
            last[phase] = loss
            if step >= t["warm"]:
                times[phase].append(ms)
        if step >= t["warm"]:
            times["global"].append((time.perf_counter() - g0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for phase, n in expect.items():
        check(per[phase] == [n, n // 2, n // 2],
              f"{phase} phase: launches of rows 3, 8, 9 {per[phase]}, "
              f"expected {[n, n // 2, n // 2]} (remat: two forwards a "
              "layer)")
        layers = esm_passes[phase] * ecfg.n_layers
        check(gelu_per[phase][0] >= 2 * layers
              and gelu_per[phase][1] >= layers,
              f"{phase} phase: launches of the GELU pair {gelu_per[phase]}, "
              f"expected at least {[2 * layers, layers]} (one a layer of "
              "the encoder's MLP, two forwards a layer under remat)")
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_bwd_dq": fa.launches_bwd_dq,
                "flash_attention_bwd_dkv": fa.launches_bwd_dkv,
                "gelu_erf": act.launches, "gelu_erf_bwd": act.launches_bwd}
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    S = sum(int(b["protein_tokens"].shape[1]) for b in mlm) / len(mlm)
    tokens = t["mlm_batch"] * S
    residues = sum(int((b["protein_tokens"] > 3).sum()) for b in mlm) \
        / len(mlm)
    fpt = esm_train_flops_per_token(ecfg, S)
    mfu = fpt * tokens / (mean["mlm"] / 1e3) / PEAK_BF16
    results = dict(
        ms_per_phase={k: mean[k] for k in ("qa", "retrieval", "mlm",
                                           "joint")},
        ms_per_global_step=mean["global"],
        mlm_tokens_per_sec=tokens / (mean["mlm"] / 1e3),
        mlm_residues_per_sec=residues / (mean["mlm"] / 1e3), mlm_mfu=mfu,
        mlm_flop_per_token=fpt, peak_gib=peak,
        launches_per_phase={k: dict(zip(("fwd", "dq", "dkv"), v))
                            for k, v in per.items()},
        gelu_launches_per_phase={k: dict(zip(("fwd", "bwd"), v))
                                 for k, v in gelu_per.items()},
        first_loss=first, last_loss=last)
    print(f"  a global step (host clock, mean of {t['timed']}): "
          + ", ".join(f"{k} {mean[k]:.1f}" for k in ("qa", "retrieval",
                                                      "mlm", "joint"))
          + f" ms; {mean['global']:.1f} ms in all")
    print(f"  MLM step: {tokens:.0f} tokens ({residues:.0f} residues) in "
          f"{mean['mlm']:.1f} ms: {results['mlm_tokens_per_sec']:.0f} "
          f"tokens/s, MFU {mfu:.1%} ({fpt * tokens:.3e} FLOP at "
          f"{PEAK_BF16:.3g}); peak memory {peak:.1f} GiB (the service's "
          f"bf16 weights included); launches a phase (fwd, dq, dkv) {per}; "
          f"of the GELU pair (fwd, bwd) {gelu_per}")
    print(f"  losses first {first}, last {last}")
    if profile:
        results["mlm_profile"] = profile_once(
            "one MLM train step (ESM2-3B, 8 x 1026)",
            lambda: trainer.steps["mlm"](trainer.state, mlm[0]),
            mean["mlm"])
    esm_params = trainer.state["params"]["esm"]
    del trainer
    return launches, (esm_params, ecfg), results


def phase_esm_serve(dev, esm_params, ecfg, store):
    """B. Serving the trained encoder: merge_lora_params, quantize_params,
    fuse_qkv_params, then one W8A8 embedding batch of B16 x S1024 (rows 1
    and 4 once a layer) against the merged bf16 encoder on the same
    batch: the per-protein cosine of the mean-pooled embeddings at least
    SANITY_COS; proteins/s of the W8A8 batch; then rows 1 and 4 alone at
    the batch's shapes (phase_attention, phase_mlp). Returns (launches of
    rows 1 and 4 in the batch, results, the two rows' entries)."""
    import torch
    from procyon_tpu_torch.models import esm2, pooling
    from procyon_tpu_torch.ops import attention_rowblock, fused_mlp
    B, S = ESM_SERVE["B"], ESM_SERVE["S"]
    t0 = time.perf_counter()
    merged = esm2.merge_lora_params(esm_params, ecfg)
    cfg = dataclasses.replace(ecfg, lora=None, attn_backend="rowblock")
    cfg8 = dataclasses.replace(cfg, quant_mode="w8a8")
    p8 = esm2.fuse_qkv_params(esm2.quantize_params(merged, cfg8))
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    toks = torch.from_numpy(esm_tokens(
        [store.protein_sequence(i) for i in range(100, 100 + B)], S - 2,
        width=S)).to(dev)
    check(tuple(toks.shape) == (B, S), f"serving batch {tuple(toks.shape)}")
    mask = (toks != esm2.PAD_IDX).to(torch.int32)

    def embed(p, c):
        with torch.no_grad():
            h = esm2.forward(p, c, toks)["hidden"]
            return pooling.pool_tokens(h, mask, "mean")
    attention_rowblock.launches = fused_mlp.launches = 0
    e8 = embed(p8, cfg8)
    torch.cuda.synchronize()
    launches = {"rowblock_attention": attention_rowblock.launches,
                "fused_ln_mlp_int8": fused_mlp.launches}
    check(all(n == ecfg.n_layers for n in launches.values()),
          f"the W8A8 batch launched {launches}, expected {ecfg.n_layers} "
          "of rows 1 and 4")
    ebf = embed(merged, cfg)
    cos = cosines(e8, ebf)
    cos_min = cos.min().item()
    check(torch.isfinite(e8.float()).all().item() and cos_min >= SANITY_COS,
          f"merged W8A8 against merged bf16: cos_min {cos_min}")
    ms8 = cuda_ms(lambda: embed(p8, cfg8), iters=3, warmup=1)
    msbf = cuda_ms(lambda: embed(merged, cfg), iters=3, warmup=1)
    out = dict(merge_quantize_fuse_s=merge_s, cos_min=cos_min,
               w8a8_ms=ms8, bf16_ms=msbf, proteins_per_sec_w8a8=B / ms8 * 1e3,
               proteins_per_sec_bf16=B / msbf * 1e3, launches=launches)
    print(f"serving the trained encoder: merge + quantize + fuse "
          f"{merge_s:.1f} s; B{B} x S{S} W8A8 {ms8:.1f} ms "
          f"({out['proteins_per_sec_w8a8']:.1f} proteins/s), merged bf16 "
          f"{msbf:.1f} ms ({out['proteins_per_sec_bf16']:.1f}); per-protein "
          f"cosine W8A8 against bf16 min {cos_min:.6f} (>= {SANITY_COS}); "
          f"launches {launches}")
    del p8, merged
    torch.cuda.empty_cache()
    # rows 1 and 4 alone at the batch's shapes (seeded inputs; not counted)
    rows = dict(rowblock_attention=phase_attention(dev, B, H=ecfg.n_heads,
                                                   S=S),
                fused_ln_mlp_int8=phase_mlp(dev, B * S, d=ecfg.dim,
                                            H=ecfg.ffn_dim))
    return launches, out, rows


def phase_esm_flash(dev, lengths):
    """C. Rows 3, 8 and 9 at ESM2-3B's training attention: B8 S1026 H40
    D64, bidirectional, right-padded to the MLM batch's `lengths` (+ cls /
    eos), and with a prefix of ESM_FLASH["P"] keys (segment 1; Skv = S + P,
    not bounded). flash_case / flash_bwd_case: each against its plain
    version, twice for the same bits, sdpa with the boolean key mask beside
    it, bounds from the allowed pairs. Returns the entries by shape."""
    import torch
    B, S, H, D, P = (ESM_FLASH[k] for k in ("B", "S", "H", "D", "P"))
    g = torch.Generator(device=dev).manual_seed(SEED + 65)
    seg = (torch.arange(S, device=dev)[None] < torch.tensor(
        [n + 2 for n in lengths], device=dev)[:, None]).to(torch.int32)
    out = {}
    for name, p in (("esm2_training_shape", 0), ("esm2_prefix_shape", P)):
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B, S + p, H, D), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        seg_kv = torch.cat([torch.ones((B, p), dtype=torch.int32,
                                       device=dev), seg], 1)
        fwd = flash_case(f"esm fwd ({name})", q, k, v, seg, seg_kv,
                         causal=False)
        bwd = flash_bwd_case(f"esm bwd ({name})", q, k, v, seg,
                             causal=False, seg_kv=seg_kv)
        out[name] = (fwd, bwd)
    return out


def esm_small_batch(store, n_res):
    """The 2-layer check's MLM batch: proteins of n_res residues (the
    first right-padded), masked by the native masking."""
    from procyon_tpu_torch import native
    seqs = [store.protein_sequence(i)[:n] for i, n in enumerate(n_res)]
    pb = native.batch_encode(seqs, max_len=max(n_res),
                             long_strategy="truncate")
    masked, labels = native.mask_for_mlm(pb.tokens, SEED + 66)
    return {"protein_tokens": masked, "mlm_labels": labels}


def esm_small_params(dev, variant):
    """The 2-layer check's encoder on the card: ESM2-3B width cut to
    ESM_SMALL["layers"] layers, seeded, with LoRA B and the adapter's up
    projection drawn N(0, b_scale^2) and the prefix rows N(0, 1), so that
    every trained leaf has a gradient and the prefix weighs in the
    attention. Returns (params, config)."""
    import torch
    from procyon_tpu_torch.models import esm2
    from procyon_tpu_torch.training import optimizer as topt
    kw = dict(n_layers=ESM_SMALL["layers"], **ESM_SMALL["variants"][variant])
    ecfg = esm_config(**kw)
    g = torch.Generator(device=dev).manual_seed(SEED + 67)
    params = esm2.init_params(g, ecfg, device=dev)
    for path, leaf in topt.tree_items(params["layers"]):
        if path[0].startswith("lora_") and path[1] == "B" \
                or path[:2] == ("adapter", "wu"):
            leaf.copy_(ESM_SMALL["b_scale"] * torch.randn(
                leaf.shape, generator=g, device=dev))
        elif path[0] == "prefix":
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev))
    return params, ecfg


def esm_small_loss(where, params, ecfg, batch, expert, rot=None):
    """One MLM loss and its gradients over the encoder's banks, prefix and
    adapter (train_step.value_and_grad, as the MLM step takes them): on
    the card in bf16 (where "card") or on the CPU in f32 from the same
    weights. rot replaces esm2.prefix_key_rotation (a planted fault).
    Returns (loss, {path: gradient in f32 on the CPU})."""
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.models import esm2, unified
    from procyon_tpu_torch.training import optimizer as topt
    from procyon_tpu_torch.training import train_step as ts
    if where == "cpu":
        params = bridge.map_tensors(lambda t: t.float().cpu(), params)
        ecfg = dataclasses.replace(ecfg, dtype=torch.float32, lora=dataclasses
                                   .replace(ecfg.lora, dtype=torch.float32))
    dev = next(iter(bridge.tree_leaves(params))).device
    cfg = unified.UnifiedConfig(llama=None, esm=ecfg, dtype=ecfg.dtype)
    opt = topt.build_optimizer(topt.OptimizerConfig(lr=1e-3))
    state = ts.init_train_state({"esm": params}, opt, trainable_predicate=(
        lambda p: any(s in p for s in ("lora_", "prefix", "adapter"))))
    b = ts.batch_to_device(batch, dev)
    orig = esm2.prefix_key_rotation
    if rot is not None:
        esm2.prefix_key_rotation = rot
    try:
        loss, _, items, grads = ts.value_and_grad(
            opt, state, True,
            lambda p: ts.mlm_loss_fn(p, cfg, b, 1.0, lora_expert=expert))
    finally:
        esm2.prefix_key_rotation = orig
    return float(loss), {"/".join(p): gr.float().cpu()
                         for (p, _), gr in zip(items, grads)}


def esm_small_errors(card, cpu):
    """(|loss error| / |loss|, 1 - the least gradient cosine, the leaf)."""
    import torch
    (lc, gc), (lr_, gr) = card, cpu
    worst, leaf = 0.0, None
    for k, b in gr.items():
        a = gc[k]
        if not b.any() and not a.any():
            continue
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()
        if 1 - cos > worst or leaf is None:
            worst, leaf = max(worst, 1 - cos), k
    return abs(lc - lr_) / abs(lr_), worst, leaf


def phase_esm_small(dev, store):
    """D. The MLM loss and the gradients of the banks, the prefix and the
    adapter at ESM2-3B width cut to 2 layers: the card in bf16 against the
    CPU in f32 from the same weights, for LoRA alone, with a prefix and
    with the adapter, each within ESM_SMALL_LOSS_RTOL (loss) and
    ESM_SMALL_COS (1 - the least cosine). Two planted faults must fail the
    check: the expert index off by one, and the prefix keys given the
    positional rotation in place of the identity."""
    from procyon_tpu_torch.ops.rotary import flat_rotary_tables
    batch = esm_small_batch(store, ESM_SMALL["residues"])
    expert = ESM_SMALL["expert"]
    readings, t0 = {}, time.perf_counter()

    def positional(ecfg):
        def rot_k(rot, P):
            # the prefix keys rotated as positions 0..P-1, the rest as they
            # are
            import torch
            cos, sin, _ = flat_rotary_tables(ecfg.head_dim, ecfg.n_heads, P)
            return (torch.cat([cos.to(rot[0]), rot[0]]),
                    torch.cat([sin.to(rot[1]), rot[1]]))
        return rot_k

    for variant in ESM_SMALL["variants"]:
        params, ecfg = esm_small_params(dev, variant)
        cpu = esm_small_loss("cpu", params, ecfg, batch, expert)
        card = esm_small_loss("card", params, ecfg, batch, expert)
        rel, cos, leaf = esm_small_errors(card, cpu)
        readings[variant] = dict(loss_rel=rel, one_minus_cos=cos, leaf=leaf,
                                 loss=card[0])
        print(f"  {variant}: loss card {card[0]:.5f}, CPU {cpu[0]:.5f} "
              f"(rel {rel:.2e} <= {ESM_SMALL_LOSS_RTOL}); 1 - least gradient "
              f"cosine {cos:.2e} ({leaf}; <= {ESM_SMALL_COS})")
        check(rel <= ESM_SMALL_LOSS_RTOL and cos <= ESM_SMALL_COS,
              f"the 2-layer ESM2-3B check ({variant}): {readings[variant]}")
        faults = [("expert off by one", dict(expert=expert + 1))]
        if variant == "prefix":
            faults.append(("prefix keys rotated by position",
                           dict(expert=expert, rot=positional(ecfg))))
        for what, kw in faults:
            bad = esm_small_loss("card", params, ecfg, batch, **kw)
            brel, bcos, bleaf = esm_small_errors(bad, cpu)
            readings[f"{variant}: {what}"] = dict(
                loss_rel=brel, one_minus_cos=bcos, leaf=bleaf)
            check(brel > ESM_SMALL_LOSS_RTOL or bcos > ESM_SMALL_COS,
                  f"the 2-layer check passes a fault: {what} ({variant})")
            print(f"  {variant}, a fault, {what}: loss rel {brel:.2e}, "
                  f"1 - least cosine {bcos:.2e} ({bleaf}): caught")
    print(f"ESM2-3B width at {ESM_SMALL['layers']} layers, one MLM loss and "
          f"its gradients, card bf16 against CPU f32 (proteins of "
          f"{ESM_SMALL['residues']} residues, expert {expert}): "
          f"{time.perf_counter() - t0:.1f} s")
    return readings


def run_esm_train_group(dev, service, profile=False):
    """The live-encoder slice: E (the native data path, whose store the
    rest reads), C (rows 3, 8, 9 at ESM2's shapes; not counted), D (the
    2-layer card-against-CPU check and its planted faults), then A with
    the counts of rows 3, 8 and 9 and of the GELU pair set to 0 before it
    and read after it,
    and B with rows 1 and 4's. Returns (launches, the kernel entries at
    ESM2's shapes, results)."""
    import tempfile

    import torch
    with tempfile.TemporaryDirectory() as tmp:
        store, data = phase_esm_data(tmp)
        lengths = [len(store.protein_sequence(i)) for i in
                   range(ESM_FLASH["B"])]
        lengths = [min(n, ESM_FLASH["S"] - 2) for n in lengths]
        lengths[0] = ESM_FLASH["S"] - 2
        entries = phase_esm_flash(dev, lengths)
        torch.cuda.empty_cache()
        small = phase_esm_small(dev, store)
        torch.cuda.empty_cache()
        launches, (esm_params, ecfg), train = phase_esm_train(
            dev, service, store, profile)
        torch.cuda.empty_cache()
        serve_launches, serve, rows = phase_esm_serve(dev, esm_params, ecfg,
                                                      store)
        del esm_params
        torch.cuda.empty_cache()
    launches.update(serve_launches)
    entries.update(rows)
    return launches, entries, dict(training=train, serving=serve,
                                   small_check=small, data=data)


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


# ---------------------------------------------------------------------------
# More than one rank (path n): two ranks share the one card over gloo
# (NCCL refuses two ranks on one device), each a process this script
# starts with `--dist-worker`; then one NCCL rank under torchrun; then the
# multi-rank dry run. Each check's one-process reference runs first in
# this process and is handed to the ranks through files.
# ---------------------------------------------------------------------------

# TP 2 serving at Llama-3-8B width (full depth: each rank holds half of
# the 16 GB of bf16 weights): bench_serving's traffic cut to 16 requests
# behind one shared 256-token prefix, 32 new tokens, in the JAX dry run's
# four modes; the logits of a fixed set of DIST_COLS vocabulary columns
# of every sampled row are held to the one-process run's
DIST = dict(world=2, serve_layers=32, requests=16, prefix=256, tail=(8, 40),
            new_tokens=32, slots=16, page=64, pages_per_seq=8, n_pages=192,
            chunk=128, wave=4, cols=8192, train_layers=8, timeout=900)
DIST_MODES = (("plain", {}, False), ("kv8", {}, True),
              ("spec_k2", {"spec_k": 2}, False),
              ("prefix+wave", {"prefix_cache": True,
                               "prefill_chunk": DIST["chunk"],
                               "prefill_batch": DIST["wave"]}, False))
# bf16 on both sides; the TP run sums wo's and w_down's partial products
# over the ranks in another order (and rounds them to bf16 once more)
DIST_LOGIT_ATOL = 0.25
# the data-parallel / FSDP QLoRA step (cell f's shape: int8 frozen base,
# LoRA r16 x 4, B2 x S2048 global, B1 a rank; depth cut to
# DIST["train_layers"]) against the one-process step on the same global
# batch, in bf16 (the kernels) and in f32 (the same weights, the int8
# base dequantized to f32, attention by mha_reference): loss and
# grad_norm relative errors; each trained leaf's gradient g within
# DIST_GRAD_RTOL of the one-process one w (||g - w|| / ||w||) and
# 1 - cos(g, w) within DIST_GRAD_COS_ERR. In bf16 the ranks' products
# at B1 round elsewhere than the one process's at B2; in f32 every
# number is held to DIST_F32_RTOL, so the bf16 gap is rounding
DIST_LOSS_RTOL = 1e-2
DIST_NORM_RTOL = 2e-2
DIST_GRAD_RTOL = 5e-2
DIST_GRAD_COS_ERR = 1e-3
DIST_F32_RTOL = 1e-4


def dist_spawn(kind, tmp, world=DIST["world"]):
    """`world` ranks of this script (--dist-worker kind), all on card 0
    (LOCAL_RANK 0), joined over gloo at a free localhost port; waits for
    them and fails unless every one exits 0. Returns the ranks' results."""
    import socket
    import torch
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "LOCAL_RANK": "0"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", kind,
         str(r), str(world), str(port), tmp], env=env, cwd=ROOT)
        for r in range(world)]
    t0 = time.perf_counter()
    try:
        rcs = [p.wait(timeout=DIST["timeout"]) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0] * world, f"dist {kind}: ranks exited {rcs}")
    return [torch.load(os.path.join(tmp, f"{kind}_rank{r}.pt"),
                       weights_only=False) for r in range(world)], \
        time.perf_counter() - t0


def dist_serving_cfg():
    import torch
    from procyon_tpu_torch.models import llama
    return llama.llama3_8b(n_layers=DIST["serve_layers"], max_seq_len=1024,
                           dtype=torch.bfloat16)


def dist_serving_pcfg(cfg, quantize_kv):
    from procyon_tpu_torch.inference import kv_pool
    return kv_pool.PagedConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, page_size=DIST["page"],
        n_pages=DIST["n_pages"], max_pages_per_seq=DIST["pages_per_seq"],
        slots=DIST["slots"], dtype=cfg.dtype, quantize_kv=quantize_kv)


def dist_serving_workload(b, vocab):
    """16 requests behind one shared 256-token prefix, 32 new tokens each;
    returns the generated tokens in submission order."""
    import numpy as np
    rng = np.random.default_rng(SEED + 61)
    prefix = list(map(int, rng.integers(4, vocab, DIST["prefix"])))
    lo, hi = DIST["tail"]
    rids = [b.submit(prefix + list(map(int, rng.integers(
        4, vocab, int(rng.integers(lo, hi + 1))))),
        max_new=DIST["new_tokens"]) for _ in range(DIST["requests"])]
    out = b.run()
    return [out[r] for r in rids]


def dist_hook(b, cols, log, replay=False, errs=None, agree=None):
    """Records (or replays) every token choice of batcher `b`: `_sample`
    and the greedy speculative `_greedy_accept`. Recording keeps the
    choice and the sampled rows' logits at `cols`; replaying returns the
    recorded choice and appends the logits' largest error and whether the
    batcher's own choice agreed."""
    import torch
    sample, accept = b._sample, b._greedy_accept

    def rows(logits):
        live = sorted(b.live)
        return live if logits.shape[0] == b.pcfg.slots and live \
            else list(range(logits.shape[0]))

    def seen(kind, logits, choice):
        got = logits[rows(logits)][..., cols].float().cpu()
        if not replay:
            log.append((kind, got, choice))
            return choice
        want_kind, want, want_choice = log[len(errs)]
        check(want_kind == kind and want.shape == got.shape,
              f"dist serving: choice {len(errs)} is a {kind} of "
              f"{tuple(got.shape)}, the one-process run's a {want_kind} of "
              f"{tuple(want.shape)}")
        check(bool(torch.isfinite(got).all()), "dist serving: non-finite "
                                               "logits")
        errs.append((got - want).abs().max().item())
        mine = choice if kind == "s" else choice[0]
        ref = want_choice if kind == "s" else want_choice[0]
        agree.append(bool(torch.equal(mine.cpu(), ref)))
        return want_choice

    def s(logits):
        t = seen("s", logits, sample(logits).cpu())
        return t.to(logits.device)

    def a(tokens, logits):
        g, m = accept(tokens, logits)
        g, m = seen("a", logits, (g.cpu(), m.cpu()))
        return g.to(logits.device), m.to(logits.device)

    b._sample, b._greedy_accept = s, a


def phase_dist_serving(dev, tmp):
    """TP 2 serving: the one-process batcher on the whole Llama-3-8B
    decoder records every choice in the four modes; two ranks rebuild the
    same seeded tree one after the other, each keeping its half (q / k / v
    / w_gate / w_up columns, wo / w_down rows, the vocabulary of lm_head;
    4 of the 8 kv heads), and replay the choices: every sampled row's
    logits within DIST_LOGIT_ATOL, rows 3 and 10 launched on each rank,
    then each mode left to its own tokens, which must be the same on both
    ranks. A planted fault (rank 1 keeps its partial wo product, skipping
    the all-reduce's sum) must fail the logits check."""
    import torch
    from procyon_tpu_torch.inference import serving
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.ops import paged_attention as pa
    cfg = dist_serving_cfg()
    torch.cuda.empty_cache()
    before_gib = torch.cuda.memory_allocated(dev) / 2 ** 30
    params = llama.init_params(SEED + 61, cfg, device=dev)
    cols = torch.randperm(cfg.vocab_size, generator=torch.Generator()
                          .manual_seed(SEED + 61))[:DIST["cols"]]
    ref = {"cols": cols, "log": {}, "tokens": {}, "launches": {},
           "seconds": {}}
    t0 = time.perf_counter()
    for name, kw, qkv in DIST_MODES:
        t1 = time.perf_counter()
        b = serving.ContinuousBatcher(params, cfg,
                                      dist_serving_pcfg(cfg, qkv), **kw)
        log = []
        dist_hook(b, cols, log)
        fa.launches = pa.launches = 0
        ref["tokens"][name] = dist_serving_workload(b, cfg.vocab_size)
        torch.cuda.synchronize()
        ref["launches"][name] = (fa.launches, pa.launches)
        ref["seconds"][name] = time.perf_counter() - t1
        ref["log"][name] = log
        del b
    one_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    torch.save(ref, os.path.join(tmp, "serve_ref.pt"))
    ranks, rank_s = dist_spawn("serve", tmp)
    out = {"layers": cfg.n_layers, "one_process_s": one_s,
           "two_ranks_s": rank_s, "card_gib_before": before_gib,
           "rank_peak_gib": [r["peak_gib"] for r in ranks],
           "rank_weights_gib": [r["weights_gib"] for r in ranks]}
    for name, _, _ in DIST_MODES:
        per = [r["modes"][name] for r in ranks]
        err = max(p["max_logit_err"] for p in per)
        check(err <= DIST_LOGIT_ATOL,
              f"dist serving {name}: logits {err} from the one-process run")
        check(all(p["replayed"] == ref["tokens"][name] for p in per),
              f"dist serving {name}: the replayed tokens are not the one-"
              "process run's")
        check(per[0]["own"] == per[1]["own"],
              f"dist serving {name}: the two ranks' own tokens differ")
        own = per[0]["own"] or ref["tokens"][name]
        for p in per:
            check(p["flash"] > 0 and p["paged"] >= 0,
                  f"dist serving {name}: launches {p['flash']} / "
                  f"{p['paged']} of rows 3 / 10 on a rank")
        if name == "plain":
            check(all(p["paged"] > 0 for p in per),
                  "dist serving plain: row 10 was not launched on a rank")
        n = sum(len(w) for w in ref["tokens"][name])
        same = sum(a == b for o, w in zip(own, ref["tokens"][name])
                   for a, b in zip(o, w)) / n
        out[name] = {"max_logit_err": err, "choices": len(per[0]["errs"]),
                     "own_choice_agrees": per[0]["agree"],
                     "replay_s": [p["seconds"] for p in per],
                     "one_process_s": ref["seconds"][name],
                     "row3_launches_per_rank": [p["flash"] for p in per],
                     "row10_launches_per_rank": [p["paged"] for p in per],
                     "one_process_launches": ref["launches"][name]}
        print(f"dist serving {name} (TP 2 over gloo on one card, "
              f"Llama-3-8B, {cfg.n_layers} layers, {DIST['requests']} "
              f"requests behind a {DIST['prefix']}-token prefix, "
              f"{DIST['new_tokens']} new tokens): {len(per[0]['errs'])} "
              f"choices replayed, logits within {err:.4f} (asserted <= "
              f"{DIST_LOGIT_ATOL}); the rank's own choice agreed on "
              f"{per[0]['agree']:.3f}"
              + (f"; left to their own tokens both ranks emit the same, "
                 f"{same:.3f} of the one-process run's" if name == "plain"
                 else "")
              + f"; {per[0]['seconds']:.1f} s a rank (one process "
              f"{ref['seconds'][name]:.1f} s); launches a rank: row 3 "
              f"{[p['flash'] for p in per]}, row 10 "
              f"{[p['paged'] for p in per]} (one process: "
              f"{ref['launches'][name]})")
        if name == "plain":
            out[name]["own_tokens_equal_one_process"] = same
    fault = max(r["fault_err"] for r in ranks)
    check(fault > DIST_LOGIT_ATOL, f"dist serving: the skipped all-reduce "
                                   f"left the logits within {fault}")
    out["fault_max_logit_err"] = fault
    print(f"dist serving: rank 1 skipping the sum after wo moves the "
          f"logits by {fault:.3f} (caught); weights a rank "
          f"{[round(r['weights_gib'], 2) for r in ranks]} GiB, peak a rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB (torch's "
          f"allocator, the transient whole tree included), "
          f"{before_gib:.1f} GiB held by this process before; one process "
          f"{one_s:.1f} s, two ranks {rank_s:.1f} s (the builds "
          f"{[round(r['build_s'], 1) for r in ranks]} s of it)")
    return out


def dist_worker_serve(rank, world, tmp):
    import torch
    import torch.distributed as dist
    from procyon_tpu_torch import parallel
    from procyon_tpu_torch.inference import serving
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.ops import paged_attention as pa
    from procyon_tpu_torch.parallel import collectives
    dev = torch.device("cuda", 0)
    mesh = parallel.create_mesh(parallel.MeshConfig(1, 1, world))
    cfg = dist_serving_cfg()
    params = None
    t0 = time.perf_counter()
    for r in range(world):          # one whole tree on the card at a time
        if r == rank:
            whole = llama.init_params(SEED + 61, cfg, device=dev)
            params = parallel.shard_params(whole, mesh, cfg,
                                           axes=("model",))
            del whole
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size()
                  for _, t in parallel.sharding.leaf_items(params))
    res = {"modes": {}, "build_s": time.perf_counter() - t0}
    ref = torch.load(os.path.join(tmp, "serve_ref.pt"), weights_only=False)
    cols = ref["cols"]
    for name, kw, qkv in DIST_MODES:
        pcfg = dist_serving_pcfg(cfg, qkv)
        b = serving.ContinuousBatcher(params, cfg, pcfg, mesh=mesh, **kw)
        errs, agree = [], []
        dist_hook(b, cols, ref["log"][name], True, errs, agree)
        fa.launches = pa.launches = 0
        t0 = time.perf_counter()
        replayed = dist_serving_workload(b, cfg.vocab_size)
        torch.cuda.synchronize()
        launches = (fa.launches, pa.launches)
        check(len(errs) == len(ref["log"][name]),
              f"dist serving {name}: {len(errs)} choices on rank {rank}, "
              f"{len(ref['log'][name])} in one process")
        del b
        seconds = time.perf_counter() - t0
        # left to its own tokens (the plain mode): both ranks must agree
        own = dist_serving_workload(serving.ContinuousBatcher(
            params, cfg, pcfg, mesh=mesh, **kw), cfg.vocab_size) \
            if name == "plain" else None
        res["modes"][name] = dict(
            max_logit_err=max(errs), errs=errs, replayed=replayed,
            agree=sum(agree) / len(agree), own=own, flash=launches[0],
            paged=launches[1], seconds=seconds)
    # the planted fault: rank 1 keeps its own partial wo product (the
    # all-reduce still runs, so the ranks stay in step)
    real = collectives.reduce_from
    calls = [0]

    def skip_wo(x, group):
        out = real(x, group)
        calls[0] += 1
        return x if rank == 1 and calls[0] % 2 == 1 else out

    b = serving.ContinuousBatcher(params, cfg, dist_serving_pcfg(cfg, False),
                                  mesh=mesh)
    errs, agree = [], []
    dist_hook(b, cols, ref["log"]["plain"], True, errs, agree)
    with patched(collectives, "reduce_from", skip_wo):
        dist_serving_workload(b, cfg.vocab_size)
    res["fault_err"] = max(errs)
    res["weights_gib"] = weights / 2 ** 30
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return res


def dist_train_setup(dev):
    """The QLoRA cell at DIST["train_layers"] layers: int8 decoder, LoRA
    r16 x 4 with B ~ N(0, 0.02^2) (so A's gradient does not vanish), the
    frozen-table projectors; the global batches (qa, qa with uneven
    supervised tokens a rank, retrieval with conflict ids)."""
    import numpy as np
    import torch
    from procyon_tpu_torch.data.collators import encode_conflict_ids
    from procyon_tpu_torch.models import llama, unified
    from procyon_tpu_torch.scripts import bench_train
    from procyon_tpu_torch.training import optimizer as topt
    lcfg = llama.llama3_8b(n_layers=DIST["train_layers"],
                           dtype=torch.bfloat16)
    cfg = bench_train.qlora_config(unified.UnifiedConfig(
        llama=lcfg, esm=None, protein_embed_dim=2560,
        token_projector_layers=3, token_projector_hidden=2560,
        retrieval_dim=1024, dtype=torch.bfloat16))
    g = torch.Generator(device=dev).manual_seed(SEED + 62)
    params = bench_train.qlora_params(
        unified.init_params(g, cfg, device=dev), cfg, g,
        b_scale=TRAIN_SMALL_B)
    t = TRAIN
    qa = bench_train.train_batch(t["B"], t["S"], lcfg.vocab_size, 2560,
                                 SEED + 63)
    uneven = dict(qa, labels=qa["labels"].copy())
    # rank 1's row: 64 supervised tokens, all one id (a gradient of its
    # own direction), against rank 0's 1024
    uneven["labels"][1, t["S"] // 2:t["S"] // 2 + 64] = 7
    uneven["labels"][1, t["S"] // 2 + 64:] = -100
    ret = dict(bench_train.train_batch(t["B"], t["S"], lcfg.vocab_size,
                                       2560, SEED + 64))
    ret["conflict_ids"] = encode_conflict_ids(3, list(range(t["B"])))
    opt = topt.build_optimizer(topt.OptimizerConfig(
        lr=t["lr"], warmup_steps=t["warmup"], total_steps=1000))
    return cfg, params, opt, {"qa": qa, "uneven": uneven, "retrieval": ret}


DIST_TRAIN_CASES = (("qa (2, 1, 1)", (2, 1, 1), "qa"),
                    ("qa (1, 2, 1)", (1, 2, 1), "qa"),
                    ("uneven (2, 1, 1)", (2, 1, 1), "uneven"),
                    ("combined (2, 1, 1)", (2, 1, 1), "combined"),
                    ("combined (1, 2, 1)", (1, 2, 1), "combined"))


def dist_train_grads(cfg, opt, state, batches, case, mesh, dev):
    """(loss, metrics, {path: whole gradient f32 on the CPU}, grad_norm) of
    a case's loss over the state's trainable leaves, as its step computes
    them (qa on expert 0; combined: qa + retrieval on expert 3)."""
    import torch
    from procyon_tpu_torch.parallel import sharding
    from procyon_tpu_torch.training import train_step as ts

    def local(b):
        b = ts.batch_to_device(b, dev)
        return sharding.shard_batch(b, mesh) if mesh is not None else b

    if case == "combined":
        qa, ret = local(batches["qa"]), local(batches["retrieval"])

        def loss_of(p):
            l1, m1 = ts.lm_loss_fn(p, cfg, qa, 1.0, lora_expert=3, mesh=mesh)
            l2, m2 = ts.retrieval_loss_fn(p, cfg, ret, 1.0, lora_expert=3,
                                          mesh=mesh)
            return l1 + l2, {**m1, **{f"retrieval/{k}": v
                                      for k, v in m2.items()}}
    else:
        b = local(batches[case])

        def loss_of(p):
            return ts.lm_loss_fn(p, cfg, b, 1.0, lora_expert=0, mesh=mesh)

    loss, metrics, items, grads = ts.value_and_grad(opt, state, True, loss_of)
    norm = float(ts.grad_norm(state, items, grads))
    sh = state.get("sharding")
    whole = {}
    for (p, _), g in zip(items, grads):
        if sh is not None:
            g = sharding.gather_leaf(g, sh.spec(p), sh.mesh,
                                     ("fsdp", "model"))
        whole["/".join(p)] = g.float().cpu()
    return float(loss), {k: float(v) for k, v in metrics.items()}, whole, \
        norm


def dist_grad_errs(got, want):
    """(the largest ||g - w|| / ||w||, its leaf, 1 - the least cosine)
    over the leaves whose one-process gradient w is not 0."""
    worst, leaf, cos_err = 0.0, None, 0.0
    for k, w in want.items():
        wn = w.norm().item()
        if wn == 0:
            continue
        g = got[k]
        err = (g - w).norm().item() / wn
        if err >= worst:
            worst, leaf = err, k
        cos = (g.flatten() @ w.flatten()).item() / max(g.norm().item() * wn,
                                                       1e-30)
        cos_err = max(cos_err, 1 - cos)
    return worst, leaf, cos_err


def dist_f32_ratio(got, want, want32):
    """(the largest ||g - f|| / ||w - f|| over the leaves, its leaf, the
    two distances there relative to ||f||, and log_temp's): how much
    farther from the f32 step f a rank's bf16 gradient g is than the
    one-process bf16 gradient w. Reported, not bounded."""
    worst, at, temp = 0.0, None, (math.nan, math.nan)
    for k, f in want32.items():
        fn = f.norm().item()
        if fn == 0:
            continue
        d_rank = (got[k] - f).norm().item() / fn
        d_one = (want[k] - f).norm().item() / fn
        ratio = d_rank / max(d_one, 1e-30)
        if k.endswith("log_temp"):
            temp = (d_one, d_rank)
        if ratio >= worst:
            worst, at = ratio, (k, d_one, d_rank)
    return worst, at, temp


def dist_train_check(got, want, f32=False):
    """(passes, errors) of a rank's (loss, metrics, grads, grad_norm)
    against the one-process one's, at the bf16 bounds or at DIST_F32_RTOL
    throughout."""
    loss_err = abs(got[0] - want[0]) / max(abs(want[0]), 1e-6)
    norm_err = abs(got[3] - want[3]) / max(abs(want[3]), 1e-12)
    grad_err, leaf, cos_err = dist_grad_errs(got[2], want[2])
    bounds = (DIST_F32_RTOL,) * 4 if f32 else (
        DIST_LOSS_RTOL, DIST_NORM_RTOL, DIST_GRAD_RTOL, DIST_GRAD_COS_ERR)
    ok = all(e <= b for e, b in zip((loss_err, norm_err, grad_err, cos_err),
                                    bounds))
    return ok, dict(loss_rel=loss_err, grad_norm_rel=norm_err,
                    grad_rel=grad_err, worst_leaf=leaf,
                    one_minus_cos=cos_err, loss=got[0], grad_norm=got[3],
                    bounds=bounds)


def dist_f32(cfg, params, dev):
    """(cfg, params) in f32: the same weights, the int8 base kept (it is
    dequantized to f32 in the products)."""
    import torch
    from procyon_tpu_torch import bridge
    f32 = torch.float32
    cfg32 = dataclasses.replace(cfg, dtype=f32, llama=dataclasses.replace(
        cfg.llama, dtype=f32, lora=dataclasses.replace(cfg.llama.lora,
                                                       dtype=f32)))
    return cfg32, bridge.to_torch(bridge.to_numpy(params), device=dev)


@contextlib.contextmanager
def reference_attention():
    """The decoder's attention by mha_reference (f32, any device) for the
    f32 steps; the kernels take bf16 only."""
    from procyon_tpu_torch.models import llama
    from procyon_tpu_torch.ops import flash_attention as fa

    def attention(q, k, v, seg_q=None, seg_kv=None, *, causal=False,
                  q_positions=None, kv_positions=None, backend=None):
        m = fa.mask_inputs(q, k, seg_q, seg_kv, q_positions, kv_positions)
        return fa.mha_reference(q, k, v, m[0], m[1], causal=causal,
                                q_positions=m[2], kv_positions=m[3])

    with patched(llama, "flash_attention", attention):
        yield


def phase_dist_train(dev, tmp):
    """Data parallelism and FSDP on the QLoRA step, two ranks over gloo on
    the one card: the one-process loss, gradients and grad_norm of each
    case on the global batch first, then the ranks on meshes (2, 1, 1)
    and (1, 2, 1) with B1 a rank, the combined QA + retrieval step with
    the global contrastive batch (conflict ids gathered). The gradients
    are compared, not only updates (AdamW's first step would hide a
    gradient summed where it should be averaged). Planted faults that
    must fail the same check: the ranks' loss means averaged with uneven
    supervised tokens a rank, and the contrastive positives taken at the
    local index."""
    import torch
    from procyon_tpu_torch.training import train_step as ts
    cfg, params, opt, batches = dist_train_setup(dev)
    state = ts.init_train_state(params, opt, ts.lora_trainable_predicate)
    ref = {}
    for case in ("qa", "uneven", "combined"):
        ref[case] = dist_train_grads(cfg, opt, state, batches, case, None,
                                     dev)
    cfg32, p32 = dist_f32(cfg, params, dev)
    del state, params
    state = ts.init_train_state(p32, opt, ts.lora_trainable_predicate)
    with reference_attention():
        for case in ("qa", "uneven", "combined"):
            ref[case, "f32"] = dist_train_grads(cfg32, opt, state, batches,
                                                case, None, dev)
    del state, p32
    torch.cuda.empty_cache()
    torch.save(ref, os.path.join(tmp, "train_ref.pt"))
    ranks, rank_s = dist_spawn("train", tmp)
    out = {"layers": DIST["train_layers"], "two_ranks_s": rank_s}
    results = []
    for (name, _, case), f32 in itertools.product(DIST_TRAIN_CASES + (
            ("fault: mean of means", None, "uneven"),
            ("fault: local positives", None, "combined")), (False, True)):
        key = (name, "f32") if f32 else name
        got = ranks[0]["cases"][key]
        for r in ranks[1:]:
            check(r["cases"][key][0] == got[0]
                  and r["cases"][key][3] == got[3],
                  f"dist train {key}: the ranks' loss / grad_norm differ")
        ok, errs = dist_train_check(got, ref[(case, "f32") if f32
                                             else case], f32)
        fault = name.startswith("fault")
        if not f32:
            ratio, at, temp = dist_f32_ratio(got[2], ref[case][2],
                                             ref[case, "f32"][2])
            errs.update(f32_ratio=ratio, f32_ratio_leaf=at[0],
                        f32_dist_one=at[1], f32_dist_ranks=at[2],
                        log_temp_f32_dist=temp)
        out[f"{name} f32" if f32 else name] = errs
        print(f"dist train {name} {'f32' if f32 else 'bf16'}: loss "
              f"{errs['loss']:.5f} (rel {errs['loss_rel']:.2e}), grad_norm "
              f"{errs['grad_norm']:.4f} (rel {errs['grad_norm_rel']:.2e}), "
              f"gradients within {errs['grad_rel']:.2e} a leaf "
              f"({errs['worst_leaf']}), 1 - least cosine "
              f"{errs['one_minus_cos']:.2e} of the one-process run's "
              f"(bounds {errs['bounds']})"
              + ("" if f32 else
                 f"; from the f32 step a leaf is at most "
                 f"{errs['f32_ratio']:.3f}x as far as the one process's "
                 f"({errs['f32_ratio_leaf']}: {errs['f32_dist_ranks']:.2e} "
                 f"against {errs['f32_dist_one']:.2e}; log_temp "
                 f"{errs['log_temp_f32_dist'][1]:.2e} against "
                 f"{errs['log_temp_f32_dist'][0]:.2e})")
              + f": {'held' if ok else 'caught' if fault else 'FAILED'}")
        results.append((key, ok, fault, errs))
    for key, ok, fault, errs in results:
        verdict = "passed" if fault else "failed"
        check(ok != fault, f"dist train {key}: {verdict} the check: {errs}")
    out["launches_per_rank"] = [r["launches"] for r in ranks]
    for r in ranks:
        check(all(n > 0 for n in r["launches"].values()),
              f"dist train: rows 3 / 8 / 9 not all launched on a rank: "
              f"{r['launches']}")
    print(f"dist train: launches a rank over the cases (rows 3, 8, 9): "
          f"{out['launches_per_rank']}; two ranks {rank_s:.1f} s (builds "
          f"included)")
    return out


def dist_worker_train(rank, world, tmp):
    import torch
    import torch.distributed as dist
    from procyon_tpu_torch import parallel
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.parallel import collectives
    from procyon_tpu_torch.training import train_step as ts
    dev = torch.device("cuda", 0)
    params = None
    for r in range(world):
        if r == rank:
            cfg, params, opt, batches = dist_train_setup(dev)
        dist.barrier()
    meshes = {}
    res = {"cases": {}}
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0

    def run(dims, case):
        mesh = meshes[dims]
        state = ts.init_train_state(params, opt, ts.lora_trainable_predicate,
                                    mesh=mesh, cfg=cfg)
        out = dist_train_grads(cfg, opt, state, batches, case, mesh, dev)
        return out if rank == 0 else (out[0], out[1], {}, out[3])

    for dims in ((2, 1, 1), (1, 2, 1)):      # every rank makes every group
        meshes[dims] = parallel.create_mesh(parallel.MeshConfig(*dims))
    for name, dims, case in DIST_TRAIN_CASES:
        res["cases"][name] = run(dims, case)
    res["launches"] = {"row3": fa.launches, "row8": fa.launches_bwd_dq,
                       "row9": fa.launches_bwd_dkv}
    bf16 = (cfg, params)
    cfg, params = dist_f32(cfg, params, dev)
    with reference_attention():
        for name, dims, case in DIST_TRAIN_CASES:
            res["cases"][name, "f32"] = run(dims, case)
    f32 = (cfg, params)

    def mean_of_means(total, count, group):
        mean = total / count.clamp_min(1)
        if group is None:
            return mean
        out = collectives.all_reduce(mean.detach(), group) / \
            dist.get_world_size(group)
        return mean + (out - mean).detach()

    for (cfg, params), tag in ((bf16, None), (f32, "f32")):
        with contextlib.ExitStack() as stack:
            if tag:
                stack.enter_context(reference_attention())
            for name, fn, case in (
                    ("fault: mean of means",
                     patched(collectives, "global_mean", mean_of_means),
                     "uneven"),
                    ("fault: local positives",
                     patched(collectives, "rank", lambda group: 0),
                     "combined")):
                with fn:
                    res["cases"][(name, tag) if tag else name] = run(
                        (2, 1, 1), case)
    return res


def phase_dist_torchrun(dev, tmp):
    """One NCCL rank under torchrun: run_pretrain --synthetic true
    --mesh_fsdp -1 --max_steps 4 through `python -m torch.distributed.run
    --standalone --nproc_per_node 1` (the NCCL group, initialize_multihost,
    the rank-0 checkpoint), against the same run as a plain process: the
    same losses, bit for bit (a mesh of one rank takes the one-process
    path)."""
    base = [sys.executable, "-m"]
    args = ["procyon_tpu_torch.scripts.run_pretrain", "--synthetic", "true",
            "--max_steps", "4", "--log_steps", "1"]
    runs = {}
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    for name, cmd in (
            ("plain", base + args),
            ("torchrun", base + ["torch.distributed.run", "--standalone",
                                 "--nproc_per_node", "1", "-m"] + args
             + ["--mesh_fsdp", "-1"])):
        out = os.path.join(tmp, f"run_{name}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--output_dir", out], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"dist {name} run_pretrain: rc "
                                    f"{proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        rows = [json.loads(line) for line in
                open(os.path.join(out, "metrics.jsonl"))]
        runs[name] = dict(losses=[{k: v for k, v in r.items()
                                   if k.endswith("loss")} for r in rows],
                          seconds=time.perf_counter() - t0,
                          stderr=proc.stderr,
                          ckpt=os.path.isdir(os.path.join(out,
                                                          "checkpoint-4")))
    check("over nccl" in runs["torchrun"]["stderr"],
          "dist torchrun: run_pretrain did not report its NCCL group")
    check(runs["torchrun"]["ckpt"] and runs["plain"]["ckpt"],
          "dist torchrun: no checkpoint-4")
    check(runs["torchrun"]["losses"] == runs["plain"]["losses"]
          and len(runs["plain"]["losses"]) == 4,
          f"dist torchrun: losses {runs['torchrun']['losses']} against "
          f"{runs['plain']['losses']}")
    print(f"dist torchrun: run_pretrain on one NCCL rank (torchrun "
          f"--standalone --nproc_per_node 1, --mesh_fsdp -1) logs the plain "
          f"run's losses bit for bit over 4 steps and rank 0 wrote "
          f"checkpoint-4 ({runs['torchrun']['seconds']:.1f} s, plain "
          f"{runs['plain']['seconds']:.1f} s)")
    return {"losses_equal": True, "steps": 4,
            "seconds": runs["torchrun"]["seconds"]}


def phase_dist_dryrun(dev):
    """scripts/dryrun_multichip.py on two gloo ranks on the card, at its own
    small shapes (bf16, the kernels; the flagship step at dim 4096)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "procyon_tpu_torch.scripts.dryrun_multichip",
         "--ranks", "2", "--device", "cuda"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0, f"dist dry run: rc {proc.returncode}: "
                                f"{proc.stdout[-1500:]} {proc.stderr[-2000:]}")
    oks = [json.loads(line.split("OK ", 1)[1]) for line in
           proc.stdout.splitlines() if line.startswith("dryrun_multichip OK")]
    check(sorted(r["rank"] for r in oks) == [0, 1],
          f"dist dry run: OK lines of ranks {[r['rank'] for r in oks]}")
    r = oks[0]
    print(f"dist dry run (2 gloo ranks on the card, mesh {r['mesh']}): "
          f"multi-task loss {r['multitask']['loss']:.4f} (one process within "
          f"{r['multitask']['loss_err']:.2e}), flagship dim "
          f"{r['flagship']['dim']} qa {r['flagship']['qa_loss']:.4f} joint "
          f"{r['flagship']['joint_loss']:.4f} (within "
          f"{r['flagship']['loss_err']:.2e}), serving logits within "
          f"{max(v['max_logit_err'] for v in r['serving'].values()):.4f} in "
          f"{list(r['serving'])}; {time.perf_counter() - t0:.1f} s")
    return r


def phase_dist_rank_shapes(dev):
    """Rows 3, 8 and 9 at the shapes a rank of path n gives them, each
    held against its plain version there: row 3 at a TP 2 rank's serving
    prefill (16 q / 4 kv heads over the gathered page context: the plain
    mode's whole prompt, B1 x 296 over 512 empty context rows, and a wave
    of the prefix-cache mode, B4 x 128 behind the 256 cached prefix
    tokens), row 3 and rows 8 / 9 at a data-parallel rank's training
    shape (B1 x S2048, 32 / 8 heads), rows 8 / 9 at the dry run's TP 2
    flagship step (B4 x S48, 16 / 4 heads)."""
    import torch
    Hq, Hkv, D = (FLASH_SHAPE[k] for k in ("Hq", "Hkv", "D"))
    m = DIST["world"]
    ctx = DIST["page"] * DIST["pages_per_seq"]
    g = torch.Generator(device=dev).manual_seed(SEED + 65)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def ints(B, n, lo=0):
        return torch.arange(lo, lo + n, dtype=torch.int32,
                            device=dev).expand(B, n)

    out = {}
    for name, B, T, filled in (
            ("whole prompt", 1, DIST["prefix"] + DIST["tail"][1], 0),
            ("prefix-cache wave", DIST["wave"], DIST["chunk"],
             DIST["prefix"])):
        seg_kv = torch.zeros((B, ctx + T), dtype=torch.int32, device=dev)
        seg_kv[:, :filled] = 1
        seg_kv[:, ctx:] = 1
        kv_pos = torch.zeros((B, ctx + T), dtype=torch.int32, device=dev)
        kv_pos[:, :filled] = ints(B, filled)
        kv_pos[:, ctx:] = ints(B, T, filled)
        out[f"row 3, TP 2 serving, {name}"] = flash_case(
            f"flash (a TP 2 rank's {name})", rnd(B, T, Hq // m, D),
            rnd(B, ctx + T, Hkv // m, D), rnd(B, ctx + T, Hkv // m, D),
            torch.ones((B, T), dtype=torch.int32, device=dev), seg_kv,
            causal=True, q_pos=ints(B, T, filled), kv_pos=kv_pos)
    S = FLASH_BWD_TRAIN["S"]
    q, k, v = rnd(1, S, Hq, D), rnd(1, S, Hkv, D), rnd(1, S, Hkv, D)
    out["row 3, a DP rank's training shape"] = flash_case(
        "flash (a DP rank's training shape)", q, k, v, None, None,
        causal=True)
    out["rows 8, 9, a DP rank's training shape"] = flash_bwd_case(
        "flash bwd (a DP rank's training shape)", q, k, v, None)
    out["rows 8, 9, the dry run's TP 2 flagship step"] = flash_bwd_case(
        "flash bwd (the dry run's TP 2 flagship step)", rnd(4, 48, Hq // m, D),
        rnd(4, 48, Hkv // m, D), rnd(4, 48, Hkv // m, D), None)
    return out


def run_dist_group(dev):
    """Path n, more than one rank: rows 3, 8, 9 and 10 at a rank's shapes
    against their plain versions, TP 2 serving, data parallelism / FSDP
    on the QLoRA step, one NCCL rank under torchrun, the dry run. Returns
    (the launches of rows 3, 8, 9 and 10 on the ranks, the results)."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    shape = dict(PAGED_SHAPE, Hq=16, Hkv=4)
    with patched(sys.modules[__name__], "PAGED_SHAPE", shape):
        row10 = phase_paged_attention(dev, DIST["slots"], False)
    rank_shapes = phase_dist_rank_shapes(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_dist_serving(dev, tmp)
        train = phase_dist_train(dev, tmp)
        nccl = phase_dist_torchrun(dev, tmp)
    dry = phase_dist_dryrun(dev)
    launches = {
        "flash_attention_fwd": sum(sum(v["row3_launches_per_rank"])
                                   for k, v in serve.items()
                                   if isinstance(v, dict)
                                   and "row3_launches_per_rank" in v)
        + sum(r["row3"] for r in train["launches_per_rank"]),
        "flash_attention_bwd_dq": sum(r["row8"]
                                      for r in train["launches_per_rank"]),
        "flash_attention_bwd_dkv": sum(r["row9"]
                                       for r in train["launches_per_rank"]),
        "paged_attention": sum(sum(v["row10_launches_per_rank"])
                               for k, v in serve.items()
                               if isinstance(v, dict)
                               and "row10_launches_per_rank" in v)}
    seconds = time.perf_counter() - t0
    print(f"dist group: {seconds:.1f} s; launches on the ranks {launches}; "
          "two ranks share one card over gloo (through the host): no speed "
          "number for NCCL on several cards")
    return launches, {"row10_tp2_shape": {k: row10[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}, "rank_shapes": rank_shapes, "serving": serve,
        "train": train, "torchrun": nccl, "dryrun": dry, "seconds": seconds}


def dist_worker_main(argv):
    """--dist-worker KIND RANK WORLD PORT TMP: one rank of a dist check,
    joined over gloo on card 0; its result goes to TMP/KIND_rankR.pt."""
    import torch
    kind, rank, world, port, tmp = argv[0], int(argv[1]), int(argv[2]), \
        argv[3], argv[4]
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from procyon_tpu_torch import parallel
    parallel.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                  backend="gloo", device="cuda")
    fn = {"serve": dist_worker_serve, "train": dist_worker_train}[kind]
    result = fn(rank, world, tmp)
    torch.save(result, os.path.join(tmp, f"{kind}_rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


class LaunchShapes:
    """Records, by patching the `_launch` of rows 3, 10, 12 and 13's
    wrappers for the length of the block, each distinct shape (sizes,
    strides, dtypes, flags) at which a path launches them, with the first
    launch's index inputs (segments and positions, page table and lengths,
    move lists). `hold` then holds each kernel against its plain version at
    every recorded shape on seeded random values, the index inputs the
    path's own."""

    def __init__(self):
        self.seen = {"flash": {}, "paged": {}, "int4": {}, "move": {}}
        self._patches = []

    def _record(self, kind, key, make):
        if key not in self.seen[kind]:
            self.seen[kind][key] = make()

    def __enter__(self):
        from procyon_tpu_torch.ops import flash_attention as fa
        from procyon_tpu_torch.ops import int4_matmul as im
        from procyon_tpu_torch.ops import page_move as pm
        from procyon_tpu_torch.ops import paged_attention as pa

        def sig(t):
            return tuple(t.shape), tuple(t.stride()), t.dtype

        def flash(q, k, v, *rest):
            *ints, causal, sm_scale, bounded, want_lse = rest
            self._record("flash", (sig(q), sig(k), sig(v), causal, sm_scale,
                                   bounded, want_lse),
                         lambda: [t.clone() for t in ints])
            return flash_launch(q, k, v, *rest)

        def paged(q, k_pool, v_pool, table, lens, n_kv, head_dim, ks, vs,
                  sm_scale):
            self._record("paged", (sig(q), sig(k_pool), tuple(table.shape),
                                   n_kv, head_dim,
                                   None if ks is None else sig(ks), sm_scale),
                         lambda: (table.clone(), lens.clone()))
            return paged_launch(q, k_pool, v_pool, table, lens, n_kv,
                                head_dim, ks, vs, sm_scale)

        def int4(x, qw):
            self._record("int4", (sig(x), sig(qw["p"]), sig(qw["s"])),
                         lambda: None)
            return int4_launch(x, qw)

        def move(pool_arr, src, dst):
            self._record("move", sig(pool_arr),
                         lambda: (src.clone(), dst.clone()))
            return move_launch(pool_arr, src, dst)

        flash_launch, paged_launch = fa._launch, pa._launch
        int4_launch, move_launch = im._launch, pm._launch
        for module, fn in ((fa, flash), (pa, paged), (im, int4), (pm, move)):
            self._patches.append(patched(module, "_launch", fn))
            self._patches[-1].__enter__()
        return self

    def __exit__(self, *exc):
        while self._patches:
            self._patches.pop().__exit__(*exc)

    def hold(self, dev, what, seed):
        """Kernel against plain at every recorded shape (ATOL + RTOL|plain|
        on outputs, LSE_TOL on live rows' lse, page moves exactly equal).
        Returns {kernel: [shapes held, worst max_abs_err]}."""
        import torch
        from procyon_tpu_torch.ops import flash_attention as fa
        from procyon_tpu_torch.ops import int4_matmul as im
        from procyon_tpu_torch.ops import page_move as pm
        from procyon_tpu_torch.ops import paged_attention as pa
        from procyon_tpu_torch.ops import quant
        g = torch.Generator(device=dev).manual_seed(seed)

        def rand(size, stride, dtype):
            t = torch.empty_strided(size, stride, dtype=dtype, device=dev)
            if dtype == torch.int8:
                return t.copy_(torch.randint(-127, 128, size, generator=g,
                                             device=dev, dtype=torch.int32))
            if dtype == torch.float32:                   # scale pools
                return t.copy_(torch.rand(size, generator=g, device=dev)
                               * 0.02 + 1e-3)
            return t.copy_(torch.randn(size, generator=g, device=dev))

        out = {}

        def note(kind, err, name):
            out.setdefault(kind, []).append((err, name))

        for (qs, ks, vs, causal, sm, bounded, want_lse), ints in \
                self.seen["flash"].items():
            q, k, v = (rand(*t) for t in (qs, ks, vs))
            o, lse = fa.flash_fwd(q, k, v, *ints, causal=causal, sm_scale=sm,
                                  bounded=bounded, want_lse=True)
            ref, ref_lse = fa.flash_fwd_ref(q, k, v, *ints, causal=causal,
                                            sm_scale=sm)
            name = (f"row 3 q {qs[0]} k {ks[0]}{' causal' if causal else ''}"
                    f"{' bounded' if bounded else ''}")
            err = (o.float() - ref.float()).abs().max().item()
            live = ref_lse > -1e29
            lse_err = (lse[live] - ref_lse[live]).abs().max().item() \
                if live.any() else 0.0
            check(within_tol(o, ref) and lse_err <= LSE_TOL,
                  f"{what}: {name}: max_abs_err {err}, lse err {lse_err}")
            note("flash_attention_fwd", err, name)
        for (qs, kps, P, n_kv, D, sps, sm), (table, lens) in \
                self.seen["paged"].items():
            q = rand(*qs)
            kp, vp = rand(*kps), rand(*kps)
            scales = [None, None] if sps is None else [rand(*sps),
                                                       rand(*sps)]
            kw = dict(n_kv_heads=n_kv, head_dim=D, k_scale_pool=scales[0],
                      v_scale_pool=scales[1], sm_scale=sm)
            o, lse = pa.paged_decode_attention_fullpage(q, kp, vp, table,
                                                        lens, **kw)
            ref, ref_lse = pa.paged_decode_attention_ref(q, kp, vp, table,
                                                         lens, **kw)
            name = (f"row 10 q {qs[0]} pool {kps[0]} {kps[2]} table "
                    f"{P}")
            err = (o.float() - ref.float()).abs().max().item()
            live = lens > 0
            lse_err = (lse[live] - ref_lse[live]).abs().max().item() \
                if live.any() else 0.0
            check(within_tol(o, ref) and lse_err <= LSE_TOL,
                  f"{what}: {name}: max_abs_err {err}, lse err {lse_err}")
            note("paged_attention", err, name)
            del kp, vp, scales
        for xs, ps, ss in self.seen["int4"]:
            k, n = xs[0][-1], ps[0][1]
            w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
            qw = quant.quantize4(w, group=k // ss[0][0])
            del w
            x = rand(*xs)
            o, ref = im.qmatvec4(x, qw), im.qmatvec4_ref(x, qw)
            name = f"row 13 x {xs[0]} k{k} n{n}"
            err = (o.float() - ref.float()).abs().max().item()
            check(within_tol(o, ref), f"{what}: {name}: max_abs_err {err}")
            note("int4_matmul", err, name)
        for ps, (src, dst) in self.seen["move"].items():
            pool = rand(*ps)
            want = pm.move_pages_direct_ref(pool.clone(), src, dst)
            got = pm.move_pages_direct(pool, src, dst)
            name = f"row 12 pool {ps[0]} {ps[2]}, {src.numel()} moves"
            check(torch.equal(got, want), f"{what}: {name}: differs")
            note("page_move", 0.0, name)
            del pool, want, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for kind, cases in out.items():
            worst = max(cases)
            names = "; ".join(n for _, n in cases) if len(cases) <= 8 \
                else f"{len(cases)} shapes"
            print(f"  {what}: {kind} within tolerance of its plain "
                  f"version (tol {ATOL} + {RTOL}|plain|, lse {LSE_TOL}; "
                  f"moves exact) at every shape the run launched it at "
                  f"({names}); worst max_abs_err {worst[0]:.3e} "
                  f"({worst[1]})")
        return {k: [len(v), max(v)[0]] for k, v in out.items()}


def phase_retrieval_cli(dev, service):
    """scripts/protein_retrieval_disease_pheno.py's `run` on the /retrieve
    service's weights, store and tokenizer over all its proteins: for two
    descriptions, the same top RETRIEVE_CLI_K proteins and scores as the
    service's own answer, and row 3 once a layer a query, held against its
    plain version at the shapes it was launched at. Returns its
    launches."""
    import torch
    from procyon_tpu_torch.ops import launch_counts, launches_since
    from procyon_tpu_torch.scripts import protein_retrieval_disease_pheno \
        as cli
    n_layers = service.cfg.llama.n_layers
    total = 0
    shapes = LaunchShapes()
    t0 = time.perf_counter()
    for source, desc in RETRIEVE_DESCRIPTIONS[:2]:
        before = launch_counts()
        with shapes:
            got = cli.run(service.params, service.cfg, service.tokenizer,
                          service.store, service.protein_ids,
                          disease_desc=desc,
                          instruction_source_dataset=source,
                          k=RETRIEVE_CLI_K, device=dev)
        n = launches_since(before)["flash_attention_fwd"]
        check(n == n_layers, f"retrieval CLI: {n} flash launches for one "
                             f"query, expected {n_layers}")
        total += n
        want = service.retrieve(task_id=f"{source}_all_retrieval",
                                disease_desc=desc, k=RETRIEVE_CLI_K)
        check([r["protein_id"] for r in got]
              == [r["protein_id"] for r in want]
              and all(abs(a["score"] - b["score"]) <= 1e-4
                      for a, b in zip(got, want)),
              f"retrieval CLI ({source}): {got} against the service's "
              f"{want}")
    torch.cuda.synchronize()
    print(f"retrieval CLI (scripts/protein_retrieval_disease_pheno.py run, "
          f"{len(service.protein_ids)} proteins embedded anew, 2 "
          f"descriptions): top {RETRIEVE_CLI_K} equal to the service's, "
          f"scores within 1e-4; {total} flash launches; "
          f"{time.perf_counter() - t0:.1f} s")
    shapes.hold(dev, "retrieval CLI", SEED + 60)
    return total


def phase_bench_decode(dev):
    """scripts/bench_decode.py through its `run`, BENCH_DECODE: bf16
    seeded weights, then int4 constant weights with the quality probe
    (its gate must pass). Each: the prefills' attention through row 3,
    every paged decode step's through row 10 once a layer, the int4 run's
    products of 16 rows through row 13 (none in bf16), each kernel held
    against its plain version at every shape the run launched it at; the
    JSON line and peak memory. Returns the launches."""
    import torch
    from procyon_tpu_torch.ops import launch_counts, launches_since
    from procyon_tpu_torch.scripts import bench_decode
    total, lines = {}, {}
    for name, extra in (("bf16", ()), ("int4", ("--quant", "--bits", "4"))):
        args = bench_decode.parse_args([*BENCH_DECODE, *extra, "--device",
                                        "cuda", "--seed", str(SEED)])
        cfg = bench_decode.bench_config(
            args.dim, args.layers, args.prompt_len + args.gen_big + 32,
            device=dev)
        t0 = time.perf_counter()
        params, n_params, wtag = bench_decode.build_params(cfg, args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        with LaunchShapes() as shapes:
            res = bench_decode.run(params, cfg, args, n_params=n_params,
                                   wtag=wtag)
        n = launches_since(before)
        line = res["line"]
        steps = 2 + 2 * (args.gen_small + args.gen_big)
        prefills = 5
        L = cfg.llama.n_layers
        check(n["paged_attention"] == L * steps,
              f"bench_decode {name}: {n['paged_attention']} paged attention "
              f"launches for {steps} steps of {L} layers")
        check(n["flash_attention_fwd"] >= L * prefills,
              f"bench_decode {name}: {n['flash_attention_fwd']} flash "
              f"launches for {prefills} prefills of {L} layers")
        check((n["int4_matmul"] > 0) == (name == "int4"),
              f"bench_decode {name}: {n['int4_matmul']} int4 launches")
        check(not res["gate_failed"], f"bench_decode {name}: the quality "
                                      f"gate failed: {line}")
        check(tuple(res["tokens"].shape) == (args.batch, 3)
              and line["value"] > 0, f"bench_decode {name}: {line}")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"bench_decode {name} (dim {args.dim}, {L} layers, "
              f"~{n_params / 1e9:.2f} B params built in {build_s:.1f} s, "
              f"B{args.batch} x L{args.prompt_len}, paged, two points at "
              f"{args.gen_small} and {args.gen_big} steps): "
              f"{line['per_step_ms']} ms a step, {line['value']} tokens/s; "
              f"launches {n}; peak memory {peak:.2f} GiB")
        print(json.dumps(line))
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        del params, res
        torch.cuda.empty_cache()
        held = shapes.hold(dev, f"bench_decode {name}", SEED + 61)
        lines[name] = dict(line, peak_gib=peak, held_shapes=held)
    return total, lines


def phase_bench_caption(dev):
    """scripts/bench_caption.py through its `run`, BENCH_CAPTION
    (Llama-3-8B int4, paged, 4 prompts x beam 10, the cascade and the flat
    page walk): the prefills' attention through row 3, the beam's
    copy-on-write page moves through row 12, the 40-row products through
    row 13, the flat arm's decode steps through row 10; the quality gate
    must pass; each kernel held against its plain version at every shape
    the run launched it at; the JSON line and peak memory. Returns the
    launches."""
    import torch
    from procyon_tpu_torch.ops import launch_counts, launches_since
    from procyon_tpu_torch.scripts import bench_caption
    args = bench_caption.parse_args([*BENCH_CAPTION, "--device", "cuda",
                                     "--seed", str(SEED)])
    cfg = bench_caption.bench_config(args)
    t0 = time.perf_counter()
    params, n_params, wtag = bench_caption.build_params(cfg, args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    with LaunchShapes() as shapes:
        res = bench_caption.run(params, cfg, args, n_params=n_params,
                                wtag=wtag)
    n = launches_since(before)
    line = res["line"]
    for key in ("flash_attention_fwd", "page_move", "int4_matmul",
                "paged_attention"):
        check(n[key] > 0, f"bench_caption: no {key} launch ({n})")
    check(not res["gate_failed"], f"bench_caption: the quality gate "
                                  f"failed: {line}")
    check(line["cascade"] and line["value"] > 0
          and line["per_step_ms_flat"] > 0, f"bench_caption: {line}")
    tokens, scores = res["captions"]
    check(bool(torch.isfinite(scores).all()), "bench_caption: scores")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"bench_caption (Llama-3-8B int4, ~{n_params / 1e9:.2f} B params "
          f"built in {build_s:.1f} s, B{args.batch} x beam "
          f"{args.beam_size}, L{args.prompt_len}, paged, two points at "
          f"{args.gen_small} and {args.gen_big} steps): cascade "
          f"{line['per_step_ms']} ms a step, flat page walk "
          f"{line['per_step_ms_flat']} ms, {line['value']} caption tokens/s; "
          f"launches {n}; peak memory {peak:.2f} GiB")
    print(json.dumps(line))
    del params, res
    torch.cuda.empty_cache()
    held = shapes.hold(dev, "bench_caption", SEED + 62)
    return n, dict(line, peak_gib=peak, held_shapes=held)


def phase_entry(dev):
    """procyon_tpu_torch/entry.entry()'s fn on the card: logits [2, 64,
    1024] and a finite retrieval loss, row 3 once a decoder layer, the
    logits' cosine to the same forward on the CPU in f32 (the plain path)
    at least SANITY_COS, row 3 held against its plain version at the
    shapes it was launched at. Returns its launches."""
    import torch
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.ops import launch_counts, launches_since
    from procyon_tpu_torch.entry import entry, entry_config
    from procyon_tpu_torch.models import unified
    before = launch_counts()
    fn, (params, batch) = entry(dev)
    with LaunchShapes() as shapes:
        logits, loss = fn(params, batch)
    torch.cuda.synchronize()
    n = launches_since(before)["flash_attention_fwd"]
    cfg = entry_config()
    check(tuple(logits.shape) == (2, 64, cfg.llama.vocab_size)
          and bool(torch.isfinite(logits.float()).all())
          and math.isfinite(float(loss)), f"entry: {logits.shape} {loss}")
    check(n == cfg.llama.n_layers, f"entry: {n} flash launches")
    c32 = dataclasses.replace(
        cfg, dtype=torch.float32,
        llama=dataclasses.replace(cfg.llama, dtype=torch.float32,
                                  attn_backend="ref"),
        esm=dataclasses.replace(cfg.esm, dtype=torch.float32,
                                attn_backend="ref"))
    p32 = bridge.map_tensors(
        lambda t: t.float().cpu() if t.is_floating_point() else t.cpu(),
        params)
    ref = unified.forward(p32, c32, {k: v.cpu() for k, v in batch.items()},
                          retrieval=True)
    cos = torch.nn.functional.cosine_similarity(
        logits.float().cpu().flatten(), ref["logits"].flatten(), dim=0)
    check(cos.item() >= SANITY_COS, f"entry: logits cosine {cos.item()}")
    print(f"entry(): fn on the card, logits {tuple(logits.shape)}, "
          f"retrieval loss {float(loss):.4f} (CPU f32 "
          f"{float(ref['retrieval_loss']):.4f}), logits cosine to the CPU's "
          f"{cos.item():.6f}; {n} flash launches")
    shapes.hold(dev, "entry()", SEED + 63)
    return n


def phase_trace(dev):
    """utils/profiling.trace around TRACE_LAUNCHES launches of row 3 at the
    training shape (B2 x S2048, Llama-3-8B widths, causal), then
    utils/trace.device_op_table on the chrome trace it wrote: one flash
    kernel row, launched TRACE_LAUNCHES times, its time a launch within
    TRACE_RTOL of the CUDA-event time of a call; one trace, which fails
    when it lacks the kernel (device_op_table raises when the trace lost a
    launched kernel)."""
    import tempfile

    import torch
    from procyon_tpu_torch.ops import flash_attention as fa
    from procyon_tpu_torch.utils import profiling, trace
    B, S = FLASH_BWD_TRAIN["B"], FLASH_BWD_TRAIN["S"]
    Hq, Hkv, D = (FLASH_SHAPE[k] for k in ("Hq", "Hkv", "D"))
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(
        torch.bfloat16) for H in (Hq, Hkv, Hkv))
    ints = fa.mask_inputs(q, k, None, None, None, None)

    def kernel():
        return fa.flash_fwd(q, k, v, *ints, causal=True,
                            sm_scale=1.0 / math.sqrt(D), bounded=True,
                            want_lse=True)

    ms = cuda_ms(kernel, iters=TRACE_LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for _ in range(TRACE_LAUNCHES):
                kernel()
        total, table = trace.device_op_table(tmp)
    rows = [r for r in table if "flash_fwd_kernel" in r[2]]
    check(len(rows) == 1, f"trace: flash kernel rows {rows} of {table}")
    t_ms, count, name, long_name = rows[0]
    per = t_ms / count
    check(count == TRACE_LAUNCHES, f"trace: {count} launches of {name}")
    check(abs(per - ms) <= TRACE_RTOL * ms,
          f"trace: {per:.4f} ms a launch in the trace, {ms:.4f} by CUDA "
          "events")
    print(f"trace (utils/profiling.trace + utils/trace.device_op_table, one "
          f"trace): {name} x{count}, {per:.4f} ms a launch "
          f"({long_name}) against {ms:.4f} ms a call by CUDA events "
          f"(within {TRACE_RTOL:.0%}); {len(table)} kernel names, "
          f"{total:.3f} ms in all")
    return dict(kernel=name, launches=count, trace_ms=per, event_ms=ms)


def run_benches(dev):
    """The "benches" phases that build their own models, each freed before
    the next: bench_decode (bf16, int4), bench_caption, entry() and the
    trace table. Returns (launches by kernel, results)."""
    import torch
    launches, results = {}, {}
    n, results["bench_decode"] = phase_bench_decode(dev)
    launches.update(n)
    n, results["bench_caption"] = phase_bench_caption(dev)
    for k, v in n.items():
        launches[k] += v
    launches["flash_attention_fwd"] += phase_entry(dev)
    torch.cuda.empty_cache()
    results["trace"] = phase_trace(dev)
    return launches, results


def run_benches_group(dev, profile):
    """--only=benches: the five bench scripts at full width and the rest of
    the slice's entry points on the synthetic service: the retrieval CLI,
    bench_w8a8 (the ESM2-650M main path and its throughput), bench_serving
    (cell e), bench_train (cell f), then run_benches."""
    import torch
    service = synthetic_service(dev)
    results = {"retrieval_cli_flash_launches": phase_retrieval_cli(
        dev, service)}
    launches, cos_min, state = phase_main_path(dev)
    rates, bench_cos = phase_throughput(dev, *state, profile=profile)
    del state
    torch.cuda.empty_cache()
    results["bench_w8a8"] = dict(proteins_per_sec=rates,
                                 cos_min_pooled_b64=bench_cos)
    results["bench_serving"] = phase_serving(dev, service, profile)[1]
    torch.cuda.empty_cache()
    results["bench_train"] = phase_train(dev, service, profile)[1]
    del service
    torch.cuda.empty_cache()
    results["launches"], more = run_benches(dev)
    results.update(more)
    return results


def run_only(dev, names, profile):
    """The build and the named groups of phases alone, for a quick
    iteration on one kernel or one check: "flash" (the forward's cases),
    "flash_bwd", "flash_fit" (the forward's cost an item and a tile pair),
    "w8a8" (phase_w8a8_prefill), "mlp" (rows 4, 5 and 6, then the ESM2-650M
    main path and its throughput, with --profile its W8A8 batch traced),
    "int4" (row 13's shapes and kernels a call), "paged" (row 10 at every
    batch, bf16 and int8, and the dead-chunk case), "times" (rows 5, 11,
    12, 13, 10, 7 and 14 timed alone, see phase_times), "swiglu" (row 7 at both
    SWIGLU_SHAPES: checks, planted faults, times and each launch's device
    time), "gelu" (the bias add + erf-GELU pair at GELU_SHAPE), "decode"
    (row 14 at 8 and 16 rows and the probe chains),
    "serving" (phase_serving on the synthetic service, with --profile a
    decode round traced), "eval" (the evaluation slice: the 2-layer
    retrieval eval check, run_eval_framework on the card and the CPU, the
    retrieval eval and a mid-train eval on the synthetic service, the
    caption path with its metrics), "bert" (the BERT slice: row 3 at
    BERT's shape, BERTScore at SciBERT width with its 2-layer check, the
    five text baselines' 2-layer checks and their runs at full width, the
    two BERTScore CLIs), "esm_train" (the live-encoder slice: the native
    data path, rows 3, 8 and 9 at ESM2-3B's shapes, the 2-layer check,
    LoRA phase training and the merged encoder served, on the synthetic
    service), "dist" (path n, more than one rank: run_dist_group),
    "benches" (run_benches_group: the five bench scripts at full width, the
    retrieval CLI, entry() and the trace table). Prints their lines and no
    result line."""
    def mlp():
        rows = [phase_mlp(dev, m) for m in MLP_ROWS]
        prequant = phase_prequant_mlp(dev)
        launches, cos_min, state = phase_main_path(dev)
        rates, bench_cos = phase_throughput(dev, *state, profile=profile)
        return dict(fused_ln_mlp_int8=rows, prequant=prequant,
                    main_path_launches=launches, cos_min=cos_min,
                    proteins_per_sec=rates, cos_min_pooled_b64=bench_cos)

    groups = {
        "flash": lambda: [phase_flash(dev, b) for b in FLASH_BATCHES]
        + [phase_flash_train(dev), phase_flash_cache(dev),
           phase_rowblock_fwd(dev)],
        "flash_bwd": lambda: phase_flash_bwd(dev),
        "flash_fit": lambda: flash_fit(dev),
        "w8a8": lambda: phase_w8a8_prefill(dev, profile)[1],
        "mlp": mlp,
        "int4": lambda: phase_int4(dev),
        "paged": lambda: phase_paged(dev),
        "times": lambda: phase_times(dev),
        "swiglu": lambda: phase_swiglu(dev),
        "gelu": lambda: phase_gelu_erf(dev),
        "decode": lambda: [phase_fused_decode(dev), phase_probes(dev)[1]],
        "serving": lambda: phase_serving(dev, synthetic_service(dev),
                                         profile)[1],
        "eval": lambda: run_eval_group(dev, profile),
        "bert": lambda: run_bert_group(dev, profile),
        "esm_train": lambda: run_esm_train_group(
            dev, synthetic_service(dev), profile)[2],
        "dist": lambda: run_dist_group(dev)[1],
        "benches": lambda: run_benches_group(dev, profile),
    }
    for name in names:
        check(name in groups, f"--only: no group {name!r} (of "
                              f"{', '.join(groups)})")
        print(json.dumps({name: groups[name]()}))
    print(nvidia_smi())
    print(f"--only {','.join(names)}: a partial run, no result line")
    return 0


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
    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker_main(sys.argv[2:])
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    profile = "--profile" in sys.argv[1:]
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]
    phase_build()
    if only:
        return run_only(dev, only[0], profile)
    # the JSON line carries each kernel's results at the shape its main
    # path gives it: ESM2-650M's B64 x L512 batch, the /retrieve request,
    # ESM2-35M's B16 x L512 batch, one beam step of the caption path
    attention = [phase_attention(dev, b) for b in ATTN_BATCHES][-1]
    h40 = phase_attention(dev, ATTN_BATCHES[-1], H=ATTN_3B_HEADS)
    attention["esm2_3b"] = {k: h40[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    flash = [phase_flash(dev, b) for b in FLASH_BATCHES]
    for key, entry in (("b16", flash[-1]),
                       ("training_shape", phase_flash_train(dev))):
        flash[0][key] = {k: entry[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "library_ms")}
    kernels = [attention,
               [phase_mlp(dev, m) for m in MLP_ROWS][-1], flash[0]]
    phase_flash_cache(dev)
    kernels.append(phase_rowblock_fwd(dev))
    kernels.append(phase_page_move(dev))
    kernels.append(phase_paged(dev))
    kernels.append(phase_int4(dev))
    bwd_entries = phase_flash_bwd(dev)
    bwd_rows = {e["name"]: e for e in bwd_entries}
    kernels.extend(bwd_entries)
    torch.cuda.empty_cache()
    staged = phase_staged_move(dev)
    kernels.extend(phase_prequant_mlp(dev))
    torch.cuda.empty_cache()
    decode_check = phase_fused_decode(dev)
    torch.cuda.empty_cache()
    probe_launches, decode_probe, blocks_probe = phase_probes(dev)
    swiglu = phase_swiglu(dev)
    torch.cuda.empty_cache()
    gelu = phase_gelu_erf(dev)
    kernels.append(staged)
    kernels.append(dict(
        name="fused_decode_mlp", route="cuda",
        source="procyon_tpu_torch/csrc/fused_decode_mlp.cu",
        replaces="scripts/probe_fused_decode.py:74",
        shape=f"M{DECODE_ROWS[-1]} d{DECODE_SHAPE['d']} "
              f"I{DECODE_SHAPE['I']}, weights cold",
        max_abs_err=decode_check["max_abs_err"],
        ms=decode_probe[DECODE_ROWS[-1]]["kernel_us"] / 1e3,
        plain_ms=decode_check["plain_ms"],
        **dict(zip(("bound_ms", "bound_by"),
                   decode_bound_ms(DECODE_ROWS[-1]))), library_ms=None,
        gate_up_ms=decode_check["gate_up_ms"],
        down_ms=decode_check["down_ms"],
        int8_route_us={M: decode_probe[M]["int8_us"] for M in DECODE_ROWS},
        bf16_route_us={M: decode_probe[M]["bf16_us"] for M in DECODE_ROWS},
        kernel_us={M: decode_probe[M]["kernel_us"] for M in DECODE_ROWS}))
    kernels.append(swiglu)
    kernels.extend(gelu)
    phase_small_reference(dev)
    launches, cos_min, state = phase_main_path(dev)
    rates, bench_cos = phase_throughput(dev, *state, profile=profile)
    del state
    torch.cuda.empty_cache()
    launches["rowblock_fwd"] = phase_esm35m(dev)
    phase_fusion_small(dev)
    torch.cuda.empty_cache()
    retrieval_eval_small = phase_retrieval_eval_small(dev)
    torch.cuda.empty_cache()
    phase_caption_small(dev)
    torch.cuda.empty_cache()
    phase_serving_small(dev)
    torch.cuda.empty_cache()
    phase_train_small(dev)
    torch.cuda.empty_cache()
    retrieve_launches, qps1, qps16, service = phase_retrieve(dev, profile)
    launches["flash_attention_fwd"] = retrieve_launches
    eval_launches, retrieval_eval = phase_retrieval_eval(dev, service)
    launches["flash_attention_fwd"] += eval_launches
    cli_launches = phase_retrieval_cli(dev, service)
    launches["flash_attention_fwd"] += cli_launches
    caption_launches, caption = phase_caption(dev, service, profile)
    launches.update(caption_launches)
    torch.cuda.empty_cache()
    serving_launches, serving_results = phase_serving(dev, service, profile)
    launches["int4_matmul"] = serving_launches["int4_matmul"]
    phase_generate_http(dev, service)
    torch.cuda.empty_cache()
    train_launches, train = phase_train(dev, service, profile)
    launches["flash_attention_bwd_dq"] = train_launches[
        "flash_attention_bwd_dq"]
    launches["flash_attention_bwd_dkv"] = train_launches[
        "flash_attention_bwd_dkv"]
    torch.cuda.empty_cache()
    esm_launches, esm_entries, esm_results = run_esm_train_group(
        dev, service, profile)
    for key, n in esm_launches.items():
        launches[key] = launches.get(key, 0) + n
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    for name in ("esm2_training_shape", "esm2_prefix_shape"):
        fwd, bwd = esm_entries[name]
        flash[0][name] = {k: fwd[k] for k in keep}
        for entry in bwd:
            bwd_rows[entry["name"]][name] = {k: entry[k] for k in keep
                                             + ("pair_ms",)}
    for k in kernels:
        if k["name"] in ("rowblock_attention", "fused_ln_mlp_int8"):
            k["esm2_3b_serving"] = {f: esm_entries[k["name"]][f]
                                    for f in keep}
    del service
    torch.cuda.empty_cache()
    bench_launches, benches = run_benches(dev)
    for key in ("flash_attention_fwd", "paged_attention", "page_move",
                "int4_matmul"):
        launches[key] += bench_launches[key]
    torch.cuda.empty_cache()
    spec = phase_speculative(dev)
    phase_train_cli(dev)
    eval_cli = phase_eval_cli(dev)
    torch.cuda.empty_cache()
    bert_launches, bert_entry, bert_results = run_bert_group(dev, profile)
    launches["flash_attention_fwd"] += bert_launches
    flash[0]["bert_shape"] = {k: bert_entry[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "live_tokens")}
    torch.cuda.empty_cache()
    small = phase_w8a8_small(dev)
    launches["fused_rms_swiglu_int8"], w8a8 = phase_w8a8_prefill(dev,
                                                                 profile)
    qa_metrics = phase_qa_eval(dev, small)
    del small
    torch.cuda.empty_cache()
    dist_launches, dist_results = run_dist_group(dev)
    for key, n in dist_launches.items():
        launches[key] += n
    launches.update(probe_launches)
    launches["page_move_staged"] = staged.pop("path_launches")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on its "
                                 "main path")
    print("earlier versions, as PERF.md section 6 records them (not "
          "measured in this run): rowblock_attention 3.9931 ms at B64 S512 "
          "H20 D64 (SIMT f32), flash_attention_bwd_dkv 1.5038 ms at B2 "
          "S2048 Hq32 Hkv8 D128 causal (mma.sync), flash_attention_bwd_dq "
          "0.5915 ms at the same shape (mma.sync; the pair with the torch "
          "delta pass 1.2725), flash_attention_fwd 0.5837 ms at the same "
          "shape, 0.3120 at B16 S512, 0.0602 at B1 S512 (mma.sync), "
          "rowblock_fwd 0.1161 ms at B16 S512 H20 D24 (mma.sync), "
          "fused_ln_mlp_int8 5.7185 ms at M32768 d1280 H5120 (mma.sync), "
          "fused_mlp_int8_prequant 33.8074 ms at M32768 d2560 H10240 "
          "(mma.sync, the MLP kernel's device time), paged_attention "
          "0.1014 ms at B80 Hq32 Hkv8 D128 P12 (int8 0.0918; SIMT f32, a "
          "block a slot and kv head), int4_matmul 0.0294 ms at w_gate k4096 "
          "n14336 16 rows and 4.732 ms a 16-row forward in 449 device "
          "kernels (a k-split kernel and a reduce kernel a call), "
          "fused_rms_swiglu_int8 4.4386 ms at M4096 d4096 H11008 and "
          "5.1191 at H14336 (mma.sync), fused_decode_mlp 0.1099 ms a layer "
          "at M16 d4096 I14336 and 0.1029 at M8 (cp.async rings a warp), "
          "ln_quant_rows 0.1683 ms at M32768 d2560 and 0.0950 at d1280 (a "
          "warp a row, a one-shot grid, an IEEE division a code), "
          "page_move_staged 0.4018 ms at 2,560 overlapping moves of 128 KiB "
          "(a gather of every source into a scratch of all the moves' rows, "
          "then a scatter)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {
        "model": "esm2-650m W8A8 fused-QKV", "card": smi,
        "cos_min_retrieval": cos_min,
        "cos_min_pooled_b64": bench_cos,
        "proteins_per_sec_bf16": rates["bf16"],
        "proteins_per_sec_w8a8": rates["w8a8"]}}))
    print(json.dumps({"main_path": {
        "model": "ProCyon-Full /retrieve (Llama-3-8B bf16, 20000 proteins)",
        "flash_launches_5_requests": retrieve_launches,
        "queries_per_sec_b1": qps1, "queries_per_sec_b16": qps16}}))
    print(json.dumps({"main_path": {
        "model": "ProCyon-Full retrieval eval (Llama-3-8B bf16, "
                 f"{retrieval_eval['queries']} {RETRIEVAL_EVAL['task']} "
                 f"queries x {retrieval_eval['targets']} targets, "
                 "run_retrieval_eval)", "card": smi,
        "flash_launches": eval_launches, **retrieval_eval,
        "small_check_max_abs_err": retrieval_eval_small,
        "midtrain_eval_qlora": train["midtrain_eval"],
        "caption_metrics": caption["caption_metrics"],
        "run_eval_framework": eval_cli}}))
    print(json.dumps({"main_path": {
        "model": "BERTScore at SciBERT-base width (512 candidates x 3 "
                 "references, layer 8) and the text baselines at full width "
                 "(PubMedBERT-base, ESM2-650M, the BioTranslator CNN, "
                 "Llama-2-7B; 2,000 proteins)", "card": smi,
        "flash_launches": bert_launches, **bert_results}}))
    print(json.dumps({"main_path": {
        "model": "ProCyon-Full captioning (8 proteins x beam 10, 200 new "
                 "tokens, paged pool, shared prefix)",
        "page_move_launches": launches["page_move"],
        "paged_attention_launches": launches["paged_attention"],
        **caption}}))
    print(json.dumps({"main_path": {
        "model": "Llama-3-8B continuous-batching serving (16 slots, 48 "
                 "requests, shared 256-token prefix, 64 new tokens, 8-step "
                 "rounds)",
        "int4_matmul_launches": launches["int4_matmul"],
        "paged_attention_launches_bf16_run":
            serving_launches["paged_attention_serving"],
        **serving_results, "speculative": spec}}))
    print(json.dumps({"main_path": {
        "model": "Llama-3-8B QLoRA training (int8 frozen base, LoRA r16x4, "
                 "B2 x S2048, remat)", "card": smi,
        "flash_fwd_launches": train_launches["flash_attention_fwd"],
        "flash_bwd_dq_launches": launches["flash_attention_bwd_dq"],
        "flash_bwd_dkv_launches": launches["flash_attention_bwd_dkv"],
        **train}}))
    print(json.dumps({"main_path": {
        "model": "live-encoder LoRA phase training (ESM2-3B bf16 + MoLoRA "
                 "r8x4 on all six projections, Llama-3-8B int8 + LoRA "
                 "r16x4; MLM 8 x 1024 residues, QA / retrieval B2 x S2048 "
                 "with 8 proteins encoded live), the merged encoder served "
                 "in W8A8 at B16 x S1024, the 2-layer check, the native "
                 "data path", "card": smi,
        "launches": esm_launches, **esm_results}}))
    print(json.dumps({"main_path": {
        "model": "probe_fused_decode (Llama-3-8B MLP, int8 weights, 32 "
                 "distinct layers), probe_fused_mlp_blocks (ESM2-3B MLP, "
                 "B64 x L512)",
        "fused_decode_launches": launches["fused_decode_mlp"],
        "ln_quant_launches": launches["ln_quant_rows"],
        "prequant_launches": launches["fused_mlp_int8_prequant"],
        "decode_us_per_layer": {
            M: {k: decode_probe[M][k] for k in ("int8_us", "kernel_us",
                                               "bf16_us", "floor_us")}
            for M in DECODE_ROWS},
        "esm3b_mlp_ms": {k: blocks_probe[k] for k in
                         ("one_pass_ms", "two_pass_ms", "ln_quant_ms")}}}))
    print(json.dumps({"main_path": {
        "model": "W8A8 Llama prefill (bench decoder: dim 4096, 30 layers, "
                 "I 11008, vocab 32000, int8): bench_prefill B4 x S2048, "
                 "bench_bind and bench_retrieval B16 x L256",
        "fused_rms_swiglu_int8_launches": launches["fused_rms_swiglu_int8"],
        **w8a8, "qa_eval_card": qa_metrics}}))
    print(json.dumps({"main_path": {
        "model": "the bench scripts at full width: bench_decode --paged "
                 "(dim 4096, 32 layers, B16 x L512; bf16, int4), "
                 "bench_caption (Llama-3-8B int4, paged, B4 x beam 10, "
                 "cascade and flat), the retrieval CLI on the /retrieve "
                 "service, entry() (bench_w8a8, bench_serving and "
                 "bench_train run in the ESM2, serving and training lines)",
        "card": smi, "launches": bench_launches,
        "retrieval_cli_flash_launches": cli_launches, **benches}}))
    print(json.dumps({"main_path": {
        "model": "more than one rank: TP 2 serving at Llama-3-8B width (32 "
                 "layers, 16 requests behind a 256-token prefix, 32 new "
                 "tokens, four modes), DP / FSDP on the QLoRA step (cell "
                 "f's shape cut to 8 layers), one NCCL rank under torchrun, "
                 "the dry run; two ranks share the card over gloo",
        "card": smi, "launches_on_the_ranks": dist_launches,
        **dist_results}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
