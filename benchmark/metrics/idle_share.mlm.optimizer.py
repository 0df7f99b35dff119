"""Share of the training cell's traced window in which the card is idle while
the host is inside the step (span train.step) but neither in its forward
nor its backward: the optimizer's update and the gradients' norm (span
train.optimizer). Read from the program's spans (harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.MLM, "optimizer")
