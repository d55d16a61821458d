"""A traced slice of the window, and its reduction to device times.

The profiler (``torch.profiler``, CUPTI) covers a fixed slice at the end
of a ``--trace 1`` run's window, whole requests or steps, the device
synchronised at both ends.  Its kernels are booked to ops by the mapping
files ``portbench/ops/*.json`` (a kernel-name prefix to an op, told apart
by the first bool template argument or by the run's mode where one
template serves two ops); cuBLAS and cuDNN products to ``cublas``, NCCL
kernels to ``nccl``, copies and fills to ``memcpy``, and every other
kernel (PyTorch's elementwise, reduction and copy kernels: the glue
between the port's kernels) to its own name under the group ``glue``.
A kernel of the program's own CUDA sources that no file maps is named on
standard error, never dropped silently.
"""

from __future__ import annotations

import heapq
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

OPS_DIR = Path(__file__).resolve().parent.parent / "ops"
GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_", "cublas", "cudnn")


def load_op_maps(ops_dir: Path = OPS_DIR) -> Dict[str, dict]:
    """Every mapping file's kernels, by prefix; a prefix in two files is
    an error."""
    out: Dict[str, dict] = {}
    for f in sorted(ops_dir.glob("*.json")):
        for k in json.loads(f.read_text())["kernels"]:
            if k["prefix"] in out:
                raise ValueError(f"kernel prefix {k['prefix']!r} mapped twice ({f.name})")
            out[k["prefix"]] = k
    return out


def program_kernels(csrc: Optional[Path] = None) -> set:
    """Names of the ``__global__`` functions in the program's CUDA sources
    (by default the installed program's ``csrc/``)."""
    if csrc is None:
        import stonkgs_tpu_torch
        csrc = Path(stonkgs_tpu_torch.__file__).resolve().parent / "csrc"
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)")
    for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        names.update(pat.findall(f.read_text(errors="replace")))
    return names


def base_name(name: str) -> str:
    """A kernel's own name, without namespaces, templates or parameters."""
    return (name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
            .split("::")[-1].replace("void ", "").strip())


def classify(name: str, maps: Dict[str, dict], mode: str) -> Tuple[str, str]:
    """(group, op): group port / cublas / nccl / memcpy / glue."""
    base = base_name(name)
    for prefix, k in maps.items():
        if base.startswith(prefix):
            if "op" in k:
                return "port", k["op"]
            if "op_by_mode" in k:
                return "port", k["op_by_mode"][mode]
            args = name.split("<", 1)[1].split(">", 1)[0].split(",") if "<" in name else []
            flag = next((a.strip() for a in args if a.strip() in ("true", "false")), "false")
            return "port", k["op_by_flag"][flag]
    low = name.lower()
    if "nccl" in low:
        return "nccl", "nccl"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy", "memcpy"
    if any(m in low for m in GEMM_MARKS):
        return "cublas", "cublas"
    return "glue", base or name


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(iv) -> float:
    return sum(b - a for a, b in iv)


def _minus(a_iv, b_iv) -> float:
    """Length of the union ``a_iv`` outside the union ``b_iv``."""
    total, j = 0.0, 0
    for a, b in a_iv:
        cur = a
        while j < len(b_iv) and b_iv[j][1] <= cur:
            j += 1
        k = j
        while cur < b and k < len(b_iv) and b_iv[k][0] < b:
            if b_iv[k][0] > cur:
                total += b_iv[k][0] - cur
            cur = max(cur, b_iv[k][1])
            k += 1
        if cur < b:
            total += b - cur
    return total


def reduce_events(events, maps: Dict[str, dict], mode: str, known: set) -> dict:
    """Device and host times of a traced slice (seconds).

    ``events``: the profiler's ``FunctionEvent`` list.  Returns
    ``op_s`` (device seconds by op), ``group_s`` (by group), ``busy_s``
    (the union of every device interval), ``compute_s`` (the union
    without NCCL), ``nccl_exposed_s`` (NCCL time while no other kernel
    runs), ``gaps`` (idle seconds between device intervals, by the
    innermost host operation running at the gap's middle), ``unmapped``
    (program kernels no mapping file names)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    op_s: Dict[str, float] = {}
    group_s: Dict[str, float] = {}
    nccl_iv, other_iv, unmapped = [], [], set()
    for name, a, b in dev:
        group, op = classify(name, maps, mode)
        if group == "glue" and base_name(name) in known:
            unmapped.add(base_name(name))
        key = op if group != "glue" else f"glue:{op}"
        op_s[key] = op_s.get(key, 0.0) + (b - a)
        group_s[group] = group_s.get(group, 0.0) + (b - a)
        (nccl_iv if group == "nccl" else other_iv).append((a, b))
    busy = union(nccl_iv + other_iv)
    compute = union(other_iv)
    gaps: Dict[str, float] = {}
    host.sort(key=lambda h: h[1])
    active: list = []   # max-heap by start of the host events begun so far
    i = 0
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(active, (-host[i][1], host[i][2], host[i][0]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)   # ended before this gap, so before every later one
        label = active[0][2] if active else "(no host operation)"
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    return {"op_s": op_s, "group_s": group_s, "busy_s": _length(busy),
            "compute_s": _length(compute),
            "nccl_exposed_s": _minus(union(nccl_iv), compute),
            "gaps": gaps, "unmapped": sorted(unmapped), "kernels": len(dev)}


def warm_profiler(device, fn) -> None:
    """Profile ``fn()`` once in set-up, so that the traced slice does not
    pay the profiler's first start (CUPTI's initialisation)."""
    s = Slice(device)
    s.start()
    fn()
    s.stop()


class Slice:
    """``torch.profiler`` over a stretch of whole requests or steps: the
    device synchronised before it starts and before it stops."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.wall_s: Optional[float] = None
        self._t0: Optional[float] = None

    def elapsed(self) -> float:
        import time
        return time.perf_counter() - self._t0

    def start(self) -> None:
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        import time

        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        return self.prof.events()
