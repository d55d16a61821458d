"""Shared arithmetic of the per-layer metric readers
(``portbench/metrics/<name>.py``), from a run's context: the unprofiled
part of the window (its seconds, requests or steps, and rows) and the
traced slice (device seconds by op and group, the union of device time,
NCCL time that no compute covers, its requests or steps).  Every share of
wall time divides by the unprofiled part's wall time a request or step,
never by the profiled slice's, whose host runs slower under the profiler.
A reader with nothing to read returns None."""

from __future__ import annotations

from typing import Optional


def _wall_per_unit(ctx: dict) -> Optional[float]:
    u = ctx.get("unprof")
    if not u or u["units"] <= 0 or u["seconds"] <= 0:
        return None
    return u["seconds"] / u["units"]


def mfu(ctx: dict, mode: str) -> Optional[float]:
    """Model FLOPs of the unprofiled part's rows over its seconds, as a
    percentage of the chips' bf16 peak."""
    if ctx.get("mode") != mode or not ctx.get("unprof") or ctx["unprof"]["seconds"] <= 0:
        return None
    u = ctx["unprof"]
    return 100.0 * u["rows"] * ctx["flops_per_row"] / (
        u["seconds"] * ctx["peak_flops"] * ctx["chips"])


def glue_pct(ctx: dict, mode: str) -> Optional[float]:
    """Device seconds of kernels that are neither the port's own nor cuBLAS
    or cuDNN products, as a percentage of all kernel seconds (copies and
    NCCL left out of both)."""
    if ctx.get("mode") != mode or "slice" not in ctx:
        return None
    g = ctx["slice"]["group_s"]
    total = g.get("port", 0.0) + g.get("cublas", 0.0) + g.get("glue", 0.0)
    return 100.0 * g.get("glue", 0.0) / total if total > 0 else None


def roofline(ctx: dict, op: str, mode: str) -> Optional[float]:
    """The op's summed bound seconds over its summed device seconds in the
    slice, as a percentage."""
    if ctx.get("mode") != mode or "slice" not in ctx:
        return None
    s = ctx["slice"]
    t = s["op_s"].get(op, 0.0)
    b = ctx["bounds_per_unit"].get(op)
    if t <= 0 or not b or s["units"] <= 0:
        return None
    return 100.0 * b["bound_s"] * s["units"] / t


def device_idle(ctx: dict, mode: str) -> Optional[float]:
    """1 - (seconds a request or step in the slice in which a kernel other
    than NCCL's runs) / (wall seconds a request or step in the unprofiled
    part), as a percentage.  NCCL kernels are left out: they stay resident
    while they wait for the other ranks, which the profiler slows unevenly."""
    if ctx.get("mode") != mode or "slice" not in ctx:
        return None
    wall = _wall_per_unit(ctx)
    s = ctx["slice"]
    if wall is None or s["units"] <= 0 or s["compute_s"] <= 0:
        return None
    return 100.0 * (1.0 - (s["compute_s"] / s["units"]) / wall)


def comm_exposed_pct(ctx: dict) -> Optional[float]:
    """NCCL seconds while no compute kernel runs, a step in the slice, over
    the wall seconds of a step in the unprofiled part, as a percentage."""
    if ctx.get("chips", 1) < 2 or "slice" not in ctx:
        return None
    wall = _wall_per_unit(ctx)
    s = ctx["slice"]
    if wall is None or s["units"] <= 0 or s["group_s"].get("nccl", 0.0) <= 0:
        return None
    return 100.0 * (s["nccl_exposed_s"] / s["units"]) / wall


def data_wait_ms(ctx: dict) -> Optional[float]:
    """Mean milliseconds a step of the unprofiled part waited in ``next()``
    on the input feed."""
    w = ctx.get("waits_s")
    if ctx.get("mode") != "pretrain" or not w:
        return None
    return 1e3 * sum(w) / len(w)
