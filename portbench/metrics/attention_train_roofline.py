"""The training attention's bound time (forward and backward) over its device time."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "attention_train", "pretrain")
