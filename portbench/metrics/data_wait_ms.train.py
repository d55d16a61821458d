"""Milliseconds a step waits for the input feed."""

from portbench.harness import readers


def read(ctx):
    return readers.data_wait_ms(ctx)
