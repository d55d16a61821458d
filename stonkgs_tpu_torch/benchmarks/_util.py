"""Shared helpers of the port's benchmarks: the card check, device timing
with CUDA events, and one JSON line per result."""

from __future__ import annotations

import json
import subprocess
from typing import Callable

import torch


def require_cuda() -> str:
    """The card's name and power limit (``nvidia-smi``); raises without a
    CUDA device: a benchmark never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn: Callable, iters: int = 20, warmup: int = 2) -> float:
    """Milliseconds a call of ``fn`` takes on the card: ``iters`` calls
    between two CUDA events after ``warmup`` calls, over ``iters``."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def emit(name: str, value: float, unit: str, **extra) -> dict:
    """Print one JSON line ``{"name", "value", "unit", ...}`` and return it."""
    rec = {"name": name, "value": value, "unit": unit, **extra}
    print(json.dumps(rec), flush=True)
    return rec
