"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file ``portbench/traffic/<name>.json``,
its limits ``portbench/limits/<cell>.json`` and the readers
``portbench/metrics/<metric>.py`` of its per-layer metrics.

A later change adds a configuration, a traffic mix, a limit file, an op
mapping or a metric as a file of its own and an entry in
``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


# The keys the harness reads from a traffic file, by mode, and from each of
# its segments: a file with any other key would state what no run does.
TRAFFIC_KEYS = {
    "embed": {"mode", "batch_size", "length_buckets", "rows_per_request", "corpus_rows",
              "check_rows", "segments"},
    "pretrain": {"mode", "batch_size", "corpus_rows", "learning_rate", "schedule_steps",
                 "checked_steps", "warmup_steps", "prefetch_depth", "segments",
                 "next_sentence_labels"},
}
SEGMENT_KEYS = {"len", "token_type", "tokens", "first", "last", "fill", "labels",
                "mask_share", "mask_id"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path = BENCH_DIR


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """A metric with ``workloads`` belongs to those cells; one without, to
    every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def check_traffic(name: str, traffic: dict) -> None:
    """Refuse a traffic file with a key that the harness does not read."""
    unknown = set(traffic) - TRAFFIC_KEYS.get(traffic.get("mode"), set())
    for seg in traffic.get("segments", []):
        unknown |= set(seg) - SEGMENT_KEYS
    if unknown:
        raise ValueError(f"traffic {name!r}: keys the harness does not read: {sorted(unknown)}")


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_benchmark(root)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / conf["file"]).read_text())
    bench_dir = root / BENCH_DIR.name
    traffic = json.loads((bench_dir / "traffic" / f"{wl['traffic']}.json").read_text())
    check_traffic(wl["traffic"], traffic)
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if metric_applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if metric_applies(m, name, names)]
    return Cell(name, wl["chips"], config, traffic, limits, e2e, per_layer, bench_dir)


def metric_reader(name: str, metrics_dir: Path = BENCH_DIR / "metrics") -> Callable:
    """``read(ctx) -> float | None`` of ``portbench/metrics/<name>.py``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell that finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.bench_dir / "metrics")(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
