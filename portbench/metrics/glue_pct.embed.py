"""Share of the embedding's kernel time outside the port's kernels and cuBLAS."""

from portbench.harness import readers


def read(ctx):
    return readers.glue_pct(ctx, "embed")
