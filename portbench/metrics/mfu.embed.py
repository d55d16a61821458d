"""Model FLOPs of the embedded rows over the window's unprofiled seconds, % of the bf16 peak."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, "embed")
