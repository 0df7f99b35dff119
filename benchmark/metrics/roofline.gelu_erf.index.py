"""Share of its roofline of the bias add + erf-GELU forward kernel
(csrc/gelu_erf.cu) in the traced calls of an index cell.

One launch a layer a call, over every row the encoder's forward holds, the
empty filler rows of the call's bucket included: tokens x ffn bf16
elements read once and written once, and the bf16 bias read once. The
least time is those bytes at the H100's 3.35 TB/s.

The tokens a call holds are its chunk rows' tokens (the record's `rows`)
scaled by the program's own counters, index.tokens (every token the
encoder runs) over index.tokens_real (those of its chunk rows): the
counters hold every call of the process, and every call of a cell has the
same lengths. A program without the kernel or the counters reads nothing.
"""

from benchmark.harness import peaks
from benchmark.models.esm2 import dims

KERNELS = {"gelu_erf": ("gelu_erf_fwd_kernel",)}

BF16 = 2


def least_time(tokens, m):
    """Seconds for one call's launches over `tokens` rows of the MLP."""
    F = m["ffn"]
    n_bytes = m["layers"] * (tokens * F * 2 * BF16 + F * BF16)
    return n_bytes / peaks.HBM_BYTES_PER_S


def tokens_held(record, counters):
    return sum(record["rows"]) * counters["index.tokens"] \
        / counters["index.tokens_real"]


def read(ctx):
    seconds, n = ctx.table.matching(KERNELS["gelu_erf"])
    if not n:
        return None
    from procyon_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", dict)()
    if not counters.get("index.tokens_real"):
        return None
    m = dims(ctx.cell.config)
    bound = sum(least_time(tokens_held(r, counters), m) for r in ctx.traced)
    return 100.0 * bound / seconds
