"""NCCL time a step that no compute kernel covers, % of the step's wall time."""

from portbench.harness import readers


def read(ctx):
    return readers.comm_exposed_pct(ctx)
