"""The whole step's share of the H100's bf16 peak in a training cell
(training/train_step's MLM step): the least time at peak for the useful
work of the window's steps over the window's time.

Useful work, over the tokens that are not padding, in bf16: the forward
(the six projections 2 * (4 * d^2 + 2 * d * F) a token a layer; attention
over keys up to each row's length, 4 * d * n^2 a row a layer; each LoRA
bank's two products, 2 * r * (in + out) a token; the masked-LM head's dense
and tied decoder, 2 * (d^2 + d * V) a token), and the backward through the
activations (the same products again for the inputs' gradients, 8 * d *
n^2 a row a layer for attention's dQ, dK, dV and dP) and through the LoRA
weights (2 * r * (in + out) a token a bank for dA and dB, besides the
activations' 2 * r * (in + out)). Remat's recompute, the recompute of the
scores inside the attention backward, and padding count nothing.
"""

from benchmark.harness import peaks
from benchmark.models.esm2 import LORA_TARGETS, dims, lora_dims


def step_ops(record, cfg, lora):
    m = dims(cfg)
    d, F, L, V = m["dim"], m["ffn"], m["layers"], m["vocab"]
    tokens = sum(record["rows"])
    sq = sum(n * n for n in record["rows"])
    linear = 2 * (4 * d * d + 2 * d * F) * tokens * L
    banks = sum(2 * lora["rank"] * sum(lora_dims(m, t))
                for t in LORA_TARGETS[lora["targets"]]) * tokens * L
    head = 2 * (d * d + d * V) * tokens
    forward = linear + banks + 4 * d * sq * L + head
    backward = linear + 2 * banks + 8 * d * sq * L + head
    return forward + backward


def read(ctx):
    ops = sum(step_ops(r, ctx.cell.config, ctx.cell.traffic["lora"])
              for r in ctx.records)
    return 100.0 * ops / peaks.BF16_FLOPS / ctx.seconds
