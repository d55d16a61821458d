"""The inference attention's bound time over its device time."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "attention_infer", "embed")
