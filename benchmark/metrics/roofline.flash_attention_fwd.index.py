"""Share of its roofline of the flash attention forward kernel
(csrc/flash_attention_fwd.cu) in the traced calls of an index cell.

One launch a layer a call, over the call's rows [R, S] with q / k / v
[R, S, H, D]. The least time at the H100's peaks for the work these inputs
need: QK^T and PV over keys up to each row's own length (4 * H * D * n^2
operations a row of n tokens, bf16), the q / k / v of the rows' tokens read
once, the whole output written once, the segment ids read once.
"""

from benchmark.harness import peaks
from benchmark.models.esm2 import dims

KERNELS = {"flash_attention_fwd": ("flash_fwd_kernel",)}


def least_time(rows, width, m):
    HD = m["heads"] * m["head_dim"]
    tokens = sum(rows)
    flops = 4 * HD * sum(n * n for n in rows)
    n_bytes = (tokens * 3 * HD * 2 + len(rows) * width * HD * 2
               + 2 * len(rows) * width * 4)
    return peaks.least_time([(flops, peaks.BF16_FLOPS)], n_bytes)


def read(ctx):
    seconds, n = ctx.table.matching(KERNELS["flash_attention_fwd"])
    if not n:
        return None
    m = dims(ctx.cell.config)
    bound = sum(least_time(r["rows"], r["width"], m) for r in ctx.traced)
    return 100.0 * bound * m["layers"] / seconds
