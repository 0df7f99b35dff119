"""Estimated-A100 denominators for the tokens/sec/chip north star (a copy
of procyon_tpu/utils/baselines.py: the same denominators and fields).

BASELINE.md's throughput target is "proteins/sec embedded + output
tokens/sec/chip >= 2x A100 tokens/sec/chip" running the reference stack.
No A100 is measured, so — mirroring bench.py's ESM row
(`baseline_estimated: true`, assumed MFU, printed denominator) — every
decode-shaped bench carries an ESTIMATED denominator built from:

  * the reference's pinned serving stack: eager HF transformers 4.31
    (the reference's README.md:61), fp16 weights (2 bytes/param), dense
    per-sequence KV cache, no continuous batching;
  * autoregressive decode is HBM-bandwidth-bound: step time ~=
    weight_bytes / achieved_bandwidth (KV traffic adds on top, so this
    UNDERestimates step time = flatters the baseline);
  * A100 80GB SXM peak HBM bandwidth 2.0 TB/s;
  * assumed achieved fraction 0.30 for eager HF decode — the same 30%
    efficiency assumption as the ESM row, consistent with widely
    reported eager Llama-7B numbers (~30 tok/s single-stream on A100 =
    ~14 GB / 33 ms ~= 0.21 of peak; 0.30 is generous to the baseline).

Two denominators are reported:
  baseline_tok_per_sec      — A100 eager-fp16 decode at the SAME batch
                              shape (grants the baseline our batching);
                              vs_baseline divides by this.
  a100_ideal_tok_per_sec    — 100% of peak bandwidth at the same shape:
                              the physical A100 ceiling, reported so the
                              assumed-fraction sensitivity is visible.
  ref_stack_tok_per_sec     — (serving only) the reference's ACTUAL
                              serving architecture: one request per
                              forward (procyon/app/main.py:56-80), i.e.
                              the same estimate at batch 1.

All fields are labeled `baseline_estimated: true`; they are modeling
assumptions, not measurements.
"""

A100_HBM_BYTES_PER_S = 2.0e12     # A100 80GB SXM peak
EAGER_BW_FRAC = 0.30              # assumed achieved fraction, eager HF
REF_WEIGHT_BYTES = 2.0            # fp16 (reference stack dtype)


def a100_decode_tok_per_sec(n_params: float, batch: int,
                            bw_frac: float = EAGER_BW_FRAC) -> float:
    """Estimated A100 decode tokens/sec at `batch` sequences: one fp16
    weight stream per step, bandwidth-bound at bw_frac of peak."""
    step_s = n_params * REF_WEIGHT_BYTES / (bw_frac * A100_HBM_BYTES_PER_S)
    return batch / step_s


def baseline_fields(n_params: float, batch: int, measured_tok_per_sec,
                    serving: bool = False) -> dict:
    """The labeled estimated-denominator fields for a bench JSON line."""
    base = a100_decode_tok_per_sec(n_params, batch)
    out = {
        "vs_baseline": round(measured_tok_per_sec / base, 3),
        "baseline_estimated": True,
        "baseline_tok_per_sec": round(base, 1),
        "baseline_model": (
            f"A100 80GB eager HF fp16 decode, batch {batch}, "
            f"bandwidth-bound at {EAGER_BW_FRAC:.0%} of 2.0 TB/s"),
        "a100_ideal_tok_per_sec": round(
            a100_decode_tok_per_sec(n_params, batch, 1.0), 1),
    }
    if serving:
        # the reference app serves ONE request per forward — the
        # framework-vs-framework number a reference user actually gets
        ref = a100_decode_tok_per_sec(n_params, 1)
        out["ref_stack_tok_per_sec"] = round(ref, 1)
        out["vs_ref_serving_stack"] = round(measured_tok_per_sec / ref, 2)
    return out
