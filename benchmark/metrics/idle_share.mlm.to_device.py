"""Share of the training cell's traced window in which the card is idle while
the host copies the step's batch to the card (span train.to_device,
training/train_step.batch_to_device). Read from the program's spans
(harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_share(ctx, spans.MLM, "to_device")
