"""Model FLOPs of the trained examples (forward and backward of what
trains, the frozen backbones forward) over the window's unprofiled
seconds, % of the chips' bf16 peak."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, "pretrain")
