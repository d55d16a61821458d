"""The serving FFN block's bound time over its device time."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "ffn_ln_block", "embed")
