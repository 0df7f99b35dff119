"""Share of the training cell's traced window in which the card is idle while
the host is in no step and no copy to the card (no train.step or
train.to_device span): the benchmark's batch generation and its read of
the loss. Read from the program's spans (harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.MLM, "outside")
