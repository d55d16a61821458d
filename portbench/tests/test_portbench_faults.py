"""A run with its timed path broken underneath comes out not correct:
every fault a cell can have, planted in the program at a tiny size on the
CPU, judged by the cell's own limits."""

import time

import numpy as np
import pytest

from portbench import control, run
from portbench.tests.tiny import tiny_cell

DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1, "card": "cpu"}


def _correct(cell, hooks=""):
    raw = run.execute(cell, 2 ** 31 + 7, 0.5, False, "cpu", time.time(), hooks)
    return run.result_line(cell, raw, False, DEVICE)["correct"]


def _engine(name):
    from stonkgs_tpu_torch.api import inference, prot_inference

    return inference.STonKGsEngine if name == "stonkgs.embed" \
        else prot_inference.ProtSTonKGsEngine


def _plant(name, monkeypatch, fault):
    """Every request's answer passed through ``fault(out, engine)``."""
    target = _engine(name)
    real = target.embed

    def planted(self, features):
        return fault(real(self, features), self)

    monkeypatch.setattr(target, "embed", planted)


@pytest.mark.parametrize("name", ["stonkgs.embed", "protstonkgs.embed"])
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    def altered(out, engine):
        out[:, 0] += np.float32(1.0)
        return out

    _plant(name, monkeypatch, altered)
    assert not _correct(tiny_cell(name))


def _misplaced(cell):
    """``correct`` and the count of answers given to the wrong row, in
    float32, where the program reproduces the reference to rounding."""
    cell.config["compute_dtype"] = "float32"
    raw = run.execute(cell, 2 ** 31 + 7, 0.5, False, "cpu", time.time())
    return (run.result_line(cell, raw, False, DEVICE)["correct"],
            raw["checks"]["rows_misplaced"])


@pytest.mark.parametrize("name", ["stonkgs.embed", "protstonkgs.embed"])
def test_rows_swapped_within_a_batch_are_not_correct(name, monkeypatch):
    cell = tiny_cell(name)
    _plant(name, monkeypatch, lambda out, engine: control.swap_rows(
        out, cell.traffic["batch_size"]))
    correct, misplaced = _misplaced(cell)
    assert not correct and misplaced > 0


@pytest.mark.parametrize("name", ["stonkgs.embed", "protstonkgs.embed"])
def test_a_stale_slot_is_not_correct(name, monkeypatch):
    stale = control.stale_slots()
    _plant(name, monkeypatch, lambda out, engine: stale(out))
    correct, misplaced = _misplaced(tiny_cell(name))
    assert not correct and misplaced > 0


@pytest.mark.parametrize("name", ["stonkgs.pretrain", "stonkgs.pretrain-dp4"])
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(name, monkeypatch):
    if name.endswith("dp4"):
        assert not _correct(tiny_cell(name), "portbench.tests.test_portbench_faults:frozen")
    else:
        from stonkgs_tpu_torch.train.optimizer import AdamW
        monkeypatch.setattr(AdamW, "update_and_apply", lambda self, *a, **k: None)
        assert not _correct(tiny_cell(name))


@pytest.mark.parametrize("name", ["stonkgs.pretrain", "stonkgs.pretrain-dp4"])
def test_half_the_batch_left_out_is_not_correct(name):
    assert not _correct(tiny_cell(name), "portbench.control:half_batch")


@pytest.mark.parametrize("name", ["stonkgs.pretrain", "stonkgs.pretrain-dp4"])
def test_an_update_without_bias_correction_is_not_correct(name):
    """The moments, and so the first gradient read from them, stay right:
    only the parameters' change can tell (float32, where the program
    reproduces the reference to rounding)."""
    cell = tiny_cell(name)
    cell.config["compute_dtype"] = "float32"
    raw = run.execute(cell, 2 ** 31 + 7, 0.5, False, "cpu", time.time(),
                      "portbench.control:no_bias_correction")
    limits = cell.limits["checks"]
    assert raw["checks"]["grad_norm_gap_median"] <= limits["grad_norm_gap_median"]["limit"]
    assert raw["checks"]["change_norm_gap_median"] > limits["change_norm_gap_median"]["limit"]
    assert not run.result_line(cell, raw, False, DEVICE)["correct"]


def test_the_exchange_left_out_is_not_correct():
    assert not _correct(tiny_cell("stonkgs.pretrain-dp4"), "portbench.control:no_exchange")


def frozen():
    """Hooks of a rank process: the optimizer applies nothing."""
    from stonkgs_tpu_torch.train.optimizer import AdamW
    AdamW.update_and_apply = lambda self, *a, **k: None
    return {}
