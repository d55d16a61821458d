"""BigBird's middle query blocks (forward) bound time over their device time, in embedding."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "bigbird_fwd", "embed")
