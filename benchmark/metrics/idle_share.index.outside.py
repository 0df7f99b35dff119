"""Share of an index cell's traced window in which the card is idle while the
host is in no call (no index.call span): the benchmark's own code between
calls. Read from the program's spans (harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.INDEX, "outside")
