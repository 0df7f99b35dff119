"""Share of an index cell's traced window in which the card is idle while the
host prepares the call's batch: tokenizes and buckets it (span
index.tokenize) or copies it to the card (index.to_device). Read from the
program's spans (harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.INDEX, "prep")
