"""The result line: its keys, the end-to-end metrics of an untraced run,
the per-layer metrics, ``device`` and ``breakdown`` of a traced one, and
``checks`` last."""

import json
import time

import pytest

from portbench import run
from portbench.tests.tiny import tiny_cell

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "card": "NVIDIA H100 80GB HBM3, 700.00 W"}


@pytest.mark.parametrize("name", ["stonkgs.embed", "stonkgs.pretrain"])
def test_untraced_line(name):
    cell = tiny_cell(name)
    raw = run.execute(cell, 5, 0.5, False, "cpu", time.time())
    out = json.loads(json.dumps(run.result_line(cell, raw, False, DEVICE)))
    assert list(out)[-1] == "checks"
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["attempted"] > 0 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def _traced_ctx(mode):
    slice_ = {"op_s": {"ffn_ln_block": 0.9, "attention_infer": 0.4, "cublas": 0.5,
                       "glue:elementwise_kernel": 0.2, "nccl": 0.1, "ffn_train": 0.3,
                       "attention_train": 0.2},
              "group_s": {"port": 1.8, "cublas": 0.5, "glue": 0.2, "nccl": 0.1},
              "gaps": {f"aten::op{i}": 0.01 * i for i in range(14)},
              "busy_s": 2.4, "compute_s": 2.35, "nccl_exposed_s": 0.05, "unmapped": [],
              "units": 20, "wall_s": 3.1, "kernels": 1000}
    from portbench.harness import work
    import json as js
    from portbench.harness.spec import BENCH_DIR
    cfg = js.loads((BENCH_DIR / "configs" / "stonkgs-base.json").read_text())
    return {"mode": mode, "chips": 1, "unit": "step", "peak_flops": 989e12,
            "unprof": {"seconds": 10.0, "units": 80, "rows": 80 * 32},
            "flops_per_row": 3e11, "slice": slice_, "waits_s": [0.001] * 80,
            "bounds_per_unit": work.op_bounds(cfg, mode, 32 if mode == "pretrain" else 128)}


@pytest.mark.parametrize("name,mode", [("stonkgs.embed", "embed"),
                                       ("stonkgs.pretrain", "pretrain")])
def test_traced_line(name, mode):
    cell = tiny_cell(name)
    raw = {"attempted": 100, "failed": 0, "memory_peak_bytes": 123,
           "checks": {k: 0.0 for k in cell.limits["checks"]}, "ctx": _traced_ctx(mode)}
    out = run.result_line(cell, raw, True, DEVICE)
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"busy_s", "window_s"} and out["device"]["busy_s"] > 0
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert len(out["breakdown"]["idle_gaps"]) == 10
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names and out["metrics"]
    for name_, m in out["metrics"].items():
        if name_.endswith("_roofline") or "mfu" in name_:
            assert 0 < m["value"] <= 100, name_
