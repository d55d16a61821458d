"""Every configuration, traffic mix, limit file, op mapping and per-layer
metric is found by name from a file of its own, and a file added beside
them is found with no edit to any file already there."""

import json
import shutil

import pytest

from portbench.harness import spec, trace
from portbench.harness.spec import BENCH_DIR, ROOT

BENCH = spec.load_benchmark()
NAMES = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", NAMES)
def test_every_cell_is_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config and cell.traffic["mode"] in ("embed", "pretrain")
    assert cell.limits["checks"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e


def test_every_file_is_used_and_named_once():
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert len(configs) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_op_maps_name_every_program_kernel():
    maps = trace.load_op_maps()
    kernels = trace.program_kernels(ROOT / "stonkgs_tpu_torch" / "csrc")
    assert kernels
    for k in kernels:
        assert trace.classify(f"void {k}<true>(int)", maps, "embed")[0] == "port", k


def test_added_files_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / BENCH_DIR.name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-bert", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny-bert.json", "reduced": [],
                             "why": "added"})
    cfg = json.loads((BENCH_DIR / "configs" / "stonkgs-base.json").read_text())
    cfg["bert"]["num_hidden_layers"] = 2
    (root / "portbench/configs/tiny-bert.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH_DIR / "traffic" / "bulk-b128.json").read_text())
    tr["rows_per_request"] = 1024
    (root / "portbench/traffic/bulk-1024.json").write_text(json.dumps(tr))
    (root / "portbench/limits/tiny.embed.json").write_text(
        json.dumps({"checks": {"worst_row_rel_err": {"limit": 0.5}}}))
    (root / "portbench/metrics/rows_seen.embed.py").write_text(
        "def read(ctx):\n    return float(ctx['unprof']['rows'])\n")
    (root / "portbench/ops/extra.json").write_text(json.dumps(
        {"why": "a new kernel", "kernels": [{"prefix": "new_fused_kernel", "op": "newop"}]}))
    bench["workloads"].append({"name": "tiny.embed", "config": "tiny-bert",
                               "traffic": "bulk-1024", "chips": 1, "why": "added"})
    for m in bench["end_to_end"]:
        if "embed" in m["name"]:
            m["workloads"].append("tiny.embed")
    bench["per_layer"].append({"name": "rows_seen.embed", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "embed_rows_per_s", "workloads": ["tiny.embed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny.embed", root)
    assert cell.config["bert"]["num_hidden_layers"] == 2
    assert cell.traffic["rows_per_request"] == 1024
    assert cell.limits["checks"]["worst_row_rel_err"]["limit"] == 0.5
    got = spec.read_per_layer(cell, {"unprof": {"rows": 7}})
    assert got["rows_seen.embed"]["value"] == 7.0
    maps = trace.load_op_maps(root / "portbench" / "ops")
    assert trace.classify("void new_fused_kernel<1>(int)", maps, "embed") == ("port", "newop")
