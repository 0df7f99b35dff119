"""Share of an index cell's traced window in which the card is idle while the
host is inside a call (span index.call) but in none of its other phases:
launching the encoder, the pooling, the regrouping of chunks and the
shared projector. Read from the program's spans (harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.INDEX, "encoder")
