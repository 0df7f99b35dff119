"""Share of the training cell's traced window in which the card is idle while
the host waits in torch.autograd.grad (span train.backward; the backward's
own thread runs under it). Read from the program's spans
(harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.MLM, "backward")
