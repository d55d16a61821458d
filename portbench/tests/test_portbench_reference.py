"""The plain reference against the port, on the CPU at a tiny size, both
in float32: embeddings of both models and three pre-training steps, one
rank and four (gloo), dropout included."""

import time

import pytest

from portbench import run
from portbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name,checks", [
    ("stonkgs.embed", ["worst_row_rel_err"]),
    ("protstonkgs.embed", ["worst_row_rel_err"]),
    ("stonkgs.pretrain", ["loss_rel_gap", "grad_norm_gap", "change_norm_gap"]),
    ("stonkgs.pretrain-dp4", ["loss_rel_gap", "grad_norm_gap", "change_norm_gap"]),
])
def test_reference_matches_the_port_in_float32(name, checks):
    cell = tiny_cell(name)
    cell.config["compute_dtype"] = "float32"
    raw = run.execute(cell, 2 ** 31 + 99, 0.5, False, "cpu", time.time())
    for c in checks:
        assert raw["checks"][c] < 2e-5, (c, raw["checks"])
