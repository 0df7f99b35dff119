"""Share of the tokens an index call feeds the encoder that are padding:
100 * (1 - index.tokens_real / index.tokens), the program's own counters
(procyon_tpu_torch/utils/profiling.counters), kept where
training/evaluation.all_protein_target_embeddings buckets a call's rows.
index.tokens counts every row the encoder runs, the empty filler rows of
the 64-row buckets included; index.tokens_real the tokens of valid rows
that are not padding (residues, CLS, EOS). The counters hold every call of
the process, and every call of a cell has the same lengths, so the share is
the traced calls' own. A program without the counters reads nothing."""


def read(ctx):
    from procyon_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    got = counters()
    if not got.get("index.tokens"):
        return None
    return 100.0 * (1.0 - got["index.tokens_real"] / got["index.tokens"])
