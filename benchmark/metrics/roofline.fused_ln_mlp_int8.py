"""Share of its roofline of the fused LayerNorm + int8 MLP
(csrc/fused_ln_mlp_int8.cu: the row pass, the up and the down kernel of one
launch) in the traced calls of an index cell.

One launch a layer a call. The least time at the H100's peaks for the work
the call's tokens need (the pad rows it is handed are not counted): the two
int8 products, 2 * 2 * d * F operations a token at the int8 peak; a token's
bf16 row read and written once, the int8 weights read once, and the f32
scales, biases and LayerNorm vectors read once.
"""

from benchmark.harness import peaks
from benchmark.models.esm2 import dims

KERNELS = {"fused_ln_mlp_int8": ("ln_quant_rows_kernel", "mlp_up_kernel",
                                 "mlp_down_kernel")}


def least_time(rows, m):
    d, F = m["dim"], m["ffn"]
    tokens = sum(rows)
    ops = 4 * tokens * d * F
    n_bytes = 2 * tokens * d * 2 + 2 * d * F + (2 * F + 4 * d) * 4
    return peaks.least_time([(ops, peaks.INT8_OPS)], n_bytes)


def read(ctx):
    seconds, n = ctx.table.matching(KERNELS["fused_ln_mlp_int8"])
    if not n:
        return None
    m = dims(ctx.cell.config)
    bound = sum(least_time(r["rows"], m) for r in ctx.traced)
    return 100.0 * bound * m["layers"] / seconds
