"""Share of the training cell's traced window in which the card is idle while
the host runs the step's forward (span train.forward, the rotary tables of
esm2.rotary included). Read from the program's spans (harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.MLM, "forward")
