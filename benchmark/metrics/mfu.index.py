"""The whole call's share of the H100's peak in an index cell
(models/unified.protein_embed_fn inside training/evaluation.
all_protein_target_embeddings): the least time at peak for the useful work
of the window's calls over the window's time.

Useful work is that of the tokens that are not padding (residues, CLS and
EOS), counted per layer: the four attention projections and the two MLP
products, 2 * (4 * d^2 + 2 * d * F) operations a token, at the int8 peak
in the W8A8 layout and the bf16 peak otherwise; attention over keys up to
each row's own length, 4 * d * n^2 a row of n tokens, bf16. Then the shared
projector, 2 * d * out a protein, bf16. Padding and empty rows count
nothing.
"""

from benchmark.harness import peaks
from benchmark.models.esm2 import dims


def least_time(record, cfg):
    m = dims(cfg)
    d, F, L = m["dim"], m["ffn"], m["layers"]
    tokens = sum(record["rows"])
    linear = 2 * (4 * d * d + 2 * d * F) * tokens * L
    attn = 4 * d * sum(n * n for n in record["rows"]) * L
    proj = 2 * d * cfg["projector"]["retrieval_dim"] * record["proteins"]
    rate = peaks.INT8_OPS if cfg["layout"]["weights"] == "w8a8" \
        else peaks.BF16_FLOPS
    return linear / rate + (attn + proj) / peaks.BF16_FLOPS


def read(ctx):
    bound = sum(least_time(r, ctx.cell.config) for r in ctx.records)
    return 100.0 * bound / ctx.seconds
