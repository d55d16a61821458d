"""No module that the harness or the reference loads is JAX, jaxlib, flax
or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), and the reference loads nothing of the
port either."""

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import run
from portbench.harness.guard import FORBIDDEN as NAMES
from portbench.harness.spec import BENCH_DIR, ROOT

FORBIDDEN = set(NAMES)


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                     "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", ["stonkgs.embed", "protstonkgs.embed", "stonkgs.pretrain",
                                  "stonkgs.pretrain-dp4"])
def test_a_run_loads_no_jax(name):
    """In the process that prints the result, and in every rank process a
    run spawns (four gloo ranks for the data-parallel cell)."""
    code = (
        "import sys, json, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "from portbench import run, control\n"
        "from portbench.harness import spec\n"
        f"cell = tiny_cell({name!r})\n"
        "raw = run.execute(cell, 3, 0.3, False, 'cpu', time.time())\n"
        "for m in cell.per_layer: spec.metric_reader(m['name'])\n"
        "assert run.refused_modules(raw) == [], run.refused_modules(raw)\n"
        "assert cell.chips == 1 or raw['forbidden'] == []\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _modules(code)
    assert "stonkgs_tpu_torch" in mods and "portbench" in mods
    assert not mods & FORBIDDEN


def flax_in_rank():
    """Hooks of a rank process that then holds a module named ``flax``."""
    import types

    sys.modules["flax"] = types.ModuleType("flax")
    return {}


def test_a_rank_that_loads_a_forbidden_module_is_refused():
    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell("stonkgs.pretrain-dp4")
    raw = run.execute(cell, 3, 0.3, False, "cpu", time.time(),
                      "portbench.tests.test_portbench_imports:flax_in_rank")
    assert "flax" not in sys.modules
    assert run.refused_modules(raw) == ["flax"]


def test_the_reference_loads_nothing_of_either_package():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.reference.models, portbench.reference.nn, "
        "portbench.reference.train\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _modules(code)
    assert not mods & (FORBIDDEN | {"stonkgs_tpu_torch"})


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH_DIR).as_posix()
                                        for p in BENCH_DIR.rglob("*.py")))
def test_no_source_imports_jax(path):
    names = _imports(BENCH_DIR / path)
    assert not names & FORBIDDEN
    if path.startswith("reference/"):
        assert "stonkgs_tpu_torch" not in names
