"""Share of an index cell's traced window in which the card is idle while the
host copies the call's embeddings back (span index.to_host). Read from the
program's spans (harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.INDEX, "to_host")
