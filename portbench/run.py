"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``stonkgs_tpu_torch``) and ``BENCHMARK.json``, on a machine with as many
CUDA cards as the cell asks for.  With ``--trace 0`` the last line of
standard output is the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, from a profiled slice at the end of the window.  The
numbers compared with the plain reference are the last lines of standard
error, each beside its limit, and the last key of the result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
TRACE_SECONDS = 4.0


def process_start_epoch() -> float:
    """Wall-clock time at which this process started (Linux ``/proc``)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start_epoch()


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    few host threads a process (set before torch is imported)."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def refused_modules(raw: dict) -> list:
    """The forbidden modules loaded in this process once the window has
    closed, and in any rank process the run spawned."""
    from portbench.harness.guard import forbidden_modules

    return sorted(set(forbidden_modules()) | set(raw.get("forbidden", [])))


def device_info(chips: int) -> dict:
    import subprocess

    import torch

    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        card = smi[0] if smi else name
    except (OSError, subprocess.SubprocessError):
        card = name
    return {"platform": "gpu", "kind": name, "count": chips, "card": card}


def breakdown(ctx: dict) -> dict:
    s = ctx["slice"]
    ops = sorted(s["op_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(s["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            hooks_name: str = "") -> dict:
    """Set-up, window, reference check: the run's raw numbers."""
    mode = cell.traffic["mode"]
    if mode == "embed":
        from portbench.harness import embed
        return embed.run(cell, seed, seconds, trace, device, t_start, TRACE_SECONDS, _log)
    if mode == "pretrain":
        from portbench.harness import train
        return train.run(cell, seed, seconds, trace, device, t_start, TRACE_SECONDS, _log,
                         hooks_name)
    raise ValueError(f"unknown traffic mode {mode!r}")


def result_line(cell, raw: dict, trace: bool, device: dict) -> dict:
    """The result object, its ``checks`` last."""
    from portbench.harness.spec import read_per_layer

    checks = {}
    correct = raw["failed"] == 0
    for name, lim in cell.limits["checks"].items():
        if "limit" not in lim:
            continue
        value = raw["checks"][name]
        ok = math.isfinite(value) and value <= lim["limit"]
        correct = correct and ok
        checks[name] = {"value": value, "limit": lim["limit"]}
    if trace:
        ctx = raw["ctx"]
        for m in cell.per_layer:
            if m["name"].endswith("_roofline"):
                op = m["name"][: -len("_roofline")]
                b = ctx["bounds_per_unit"].get(op)
                if b:
                    by = "operations" if b["flops_s"] >= b["bytes_s"] else "bytes"
                    _log(f"# {m['name']}: bound by {by} ({b['flops_s'] * 1e3:.4f} ms of "
                         f"operations, {b['bytes_s'] * 1e3:.4f} ms of bytes a "
                         f"{ctx['unit']}); {device['card']}")
        for k in ctx["slice"]["unmapped"]:
            _log(f"# program kernel {k} is in no op mapping (portbench/ops/*.json)")
        metrics = read_per_layer(cell, ctx)
    else:
        metrics = {m["name"]: {"value": raw["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": device["platform"], "kind": device["kind"], "count": device["count"],
           "memory_peak_bytes": raw["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": raw["attempted"], "failed": raw["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        s = raw["ctx"]["slice"]
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["wall_s"]
        out["breakdown"] = breakdown(raw["ctx"])
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    set_cache_dirs()
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import stonkgs_tpu_torch  # noqa: F401
    except ImportError as e:
        _log(f"portbench: the program is not in this checkout ({e})")
        return 4
    _log(f"# {args.workload} seed {args.seed}")
    raw = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    device = device_info(cell.chips)   # after the ranks: no context on card 0 meanwhile
    _log(f"# {device['card']}")
    found = refused_modules(raw)
    if found:
        _log(f"portbench: modules that must not load were loaded: {found}")
        return 5
    out = result_line(cell, raw, bool(args.trace), device)
    for name, c in out["checks"].items():
        _log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
