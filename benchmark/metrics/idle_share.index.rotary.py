"""Share of an index cell's traced window in which the card is idle while the
host builds the rotary tables and copies them to the card (span
esm2.rotary, inside models/esm2.forward). Read from the program's spans
(harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.INDEX, "rotary")
