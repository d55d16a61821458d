"""Profiling and step timing.

The port of the JAX package's ``stonkgs_tpu/utils/profiling.py``:
:func:`trace` records the enclosed block with ``torch.profiler`` (the
host's ops and, with a card, its kernels) and writes a Chrome/Perfetto
trace file; :func:`annotate` names a span of it; :class:`StepTimer` keeps
rolling step statistics and synchronises with the card at each step's end,
where the JAX one fetches a scalar.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is there) and write ``log_dir/trace.json``, a Chrome trace that
    Perfetto opens.  Yields the profiler, whose ``key_averages()`` sum the
    block's ops and kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named span in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _sync(value=None) -> None:
    if isinstance(value, torch.Tensor):
        float(value.reshape(-1)[0])
    elif value is not None:
        float(np.asarray(value).reshape(-1)[0])
    elif torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Rolling wall-clock statistics of the last ``window`` steps.

    Each step is timed from :meth:`start` to :meth:`stop`, both after the
    card has finished its queued work (``torch.cuda.synchronize``, or the
    fetch of a value of the step's output passed to ``stop``), so a step
    counts the card's time, not only its launches."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        """Mark the start of a timed step."""
        _sync()
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        """Mark the end of a timed step (after fetching one element of
        ``sync_value``, or synchronising with the card) and record it."""
        _sync(sync_value)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        """Mean seconds a step over the window."""
        return float(np.mean(self._times)) if self._times else 0.0

    @property
    def p50(self) -> float:
        """Median seconds a step over the window."""
        return float(np.median(self._times)) if self._times else 0.0

    def throughput(self, items_per_step: int) -> float:
        """Items a second at the window's mean step time."""
        return items_per_step / self.mean if self.mean else 0.0
