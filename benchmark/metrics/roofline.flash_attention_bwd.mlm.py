"""Share of its roofline of the flash attention backward (csrc/
flash_attention_bwd.cu: the dq kernel and the dk / dv kernel) in the traced
steps of a training cell.

One launch of each a layer a step, over the step's rows [R, S]. The least
time at the H100's peaks for the work these inputs need: the five products
of the backward (S = QK^T again, dP = dO V^T, dV = P^T dO, dQ = dS K,
dK = dS^T Q) over keys up to each row's own length, 10 * H * D * n^2
operations a row of n tokens in bf16; q, k, v, o and dO of the rows' tokens
read once, the log-sum-exp read once, dq, dk and dv written whole once.
"""

from benchmark.harness import peaks
from benchmark.models.esm2 import dims

KERNELS = {"flash_attention_bwd_dq": ("flash_bwd_dq_kernel",),
           "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel",)}


def least_time(rows, width, m):
    H, HD = m["heads"], m["heads"] * m["head_dim"]
    tokens = sum(rows)
    flops = 10 * HD * sum(n * n for n in rows)
    n_bytes = (tokens * 5 * HD * 2 + len(rows) * width * H * 4
               + 3 * len(rows) * width * HD * 2)
    return peaks.least_time([(flops, peaks.BF16_FLOPS)], n_bytes)


def read(ctx):
    seconds, n = ctx.table.matching(
        [s for syms in KERNELS.values() for s in syms])
    if not n:
        return None
    m = dims(ctx.cell.config)
    bound = sum(least_time(r["rows"], r["width"], m) for r in ctx.traced)
    return 100.0 * bound * m["layers"] / seconds
