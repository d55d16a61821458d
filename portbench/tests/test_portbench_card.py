"""On a card, at each one-card cell's own size: the program's compared
numbers stay within the cell's limits and the control's (the precision
below bf16) break at least one of them.  Run with ``-m card``."""

import argparse
import json

import pytest

from portbench import control
from portbench.harness.spec import load_cell


@pytest.mark.card
@pytest.mark.parametrize("name", ["stonkgs.embed", "protstonkgs.embed", "stonkgs.pretrain"])
def test_control_fails_and_program_passes(card, name, tmp_path):
    cell = load_cell(name)
    out = tmp_path / "readings.jsonl"
    args = argparse.Namespace(seeds="2147483911", requests=8, faults=False, out=str(out),
                              device="cuda")
    assert control.readings(cell, args) == 0
    lines = {r["side"]: r for r in map(json.loads, out.read_text().splitlines())}
    limits = cell.limits["checks"]
    assert all(lines["program"][k] <= v["limit"] for k, v in limits.items())
    assert any(lines["control"][k] > v["limit"] for k, v in limits.items())
