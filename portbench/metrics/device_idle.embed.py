"""Share of a request's wall time in which no device operation runs."""

from portbench.harness import readers


def read(ctx):
    return readers.device_idle(ctx, "embed")
