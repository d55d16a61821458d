"""Import hygiene of the port: it imports neither jax nor stonkgs_tpu.

The PyTorch/CUDA package and ``chip_smoke.py`` run on machines without
JAX, so neither may import it, nor anything of the JAX package (not even
its jax-free modules: the port keeps its own copies).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "stonkgs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "stonkgs_tpu" or name.startswith("stonkgs_tpu."))


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import stonkgs_tpu_torch\n"
        "from stonkgs_tpu_torch.api import inference\n"
        "from stonkgs_tpu_torch.ops import losses\n"
        "from stonkgs_tpu_torch.train import optimizer, pretraining\n"
        "from stonkgs_tpu_torch.api import prot_inference\n"
        "from stonkgs_tpu_torch.models import bigbird, protstonkgs\n"
        "from stonkgs_tpu_torch.ops import bigbird_sparse\n"
        "from stonkgs_tpu_torch.ops import quantization\n"
        "from stonkgs_tpu_torch.benchmarks import bench_int8_embed, bench_int8_gemm\n"
        "from stonkgs_tpu_torch.data import artifacts, fast_tokenizer, masking\n"
        "from stonkgs_tpu_torch.data import preprocessing, prot, transe, wordpiece\n"
        "from stonkgs_tpu_torch.utils import hf_export, hf_loader\n"
        "from stonkgs_tpu_torch.train import finetuning\n"
        "from stonkgs_tpu_torch.cli import finetune\n"
        "from stonkgs_tpu_torch.baselines import kg_baseline, nlp_baseline\n"
        "from stonkgs_tpu_torch.utils import batching, logging\n"
        "from stonkgs_tpu_torch.data import filters, indra_extraction, memmap_dataset\n"
        "from stonkgs_tpu_torch.train import checkpoint, dynamic_masking\n"
        "from stonkgs_tpu_torch.cli import pretrain\n"
        "from stonkgs_tpu_torch.api import api, embeddings\n"
        "from stonkgs_tpu_torch.data import kg_graph, protein_sequences, tsv_io, walker\n"
        "from stonkgs_tpu_torch.models import node2vec, word2vec\n"
        "from stonkgs_tpu_torch.baselines import batteries\n"
        "from stonkgs_tpu_torch.parallel import dryrun, mesh, multihost, tp\n"
        "from stonkgs_tpu_torch import cli, constants, version\n"
        "from stonkgs_tpu_torch.utils import cache, init, parity, profiling\n"
        "from stonkgs_tpu_torch.api import example, get_emmaa\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(new))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()
    assert "stonkgs_tpu_torch" in out
    assert "stonkgs_tpu_torch.train.pretraining" in out
    assert "stonkgs_tpu_torch.models.protstonkgs" in out
    assert "stonkgs_tpu_torch.ops.bigbird_sparse" in out
    assert "stonkgs_tpu_torch.ops.quantization" in out
    assert "stonkgs_tpu_torch.benchmarks.bench_int8_gemm" in out
    assert "stonkgs_tpu_torch.data.preprocessing" in out
    assert "stonkgs_tpu_torch.utils.hf_loader" in out
    assert "stonkgs_tpu_torch.train.finetuning" in out
    assert "stonkgs_tpu_torch.baselines.kg_baseline" in out
    assert "stonkgs_tpu_torch.cli.pretrain" in out
    assert "stonkgs_tpu_torch.api.embeddings" in out
    assert "stonkgs_tpu_torch.models.node2vec" in out
    assert "stonkgs_tpu_torch.baselines.batteries" in out
    assert "stonkgs_tpu_torch.parallel.dryrun" in out
    for name in ("cli", "constants", "version", "utils.cache", "utils.init", "utils.parity",
                 "utils.profiling", "api.example", "api.get_emmaa"):
        assert f"stonkgs_tpu_torch.{name}" in out
    assert [m for m in out if _forbidden(m)] == []


# packages the port's paths must not need: a machine that serves the
# port is given torch, numpy and g++ only
ABSENT_ON_THE_CARD = ("pandas", "transformers", "safetensors", "sklearn", "networkx", "optuna",
                      "click", "matplotlib", "seaborn")


def test_engine_path_pulls_in_no_module_the_card_lacks():
    """The README flow's, fine-tuning's, pre-training's, the serving
    API's, the KG embeddings' (the walker, the extraction, word2vec,
    node2vec, the batteries) and the parallel modules import none of pandas,
    transformers, safetensors, sklearn, networkx or optuna at module scope
    (safetensors only inside the loader, for a ``.safetensors`` file;
    pandas only inside the functions that read a TSV or a pickle or build
    a DataFrame; optuna only inside ``run_node2vec_hpo``)."""
    code = (
        "import sys\n"
        "from stonkgs_tpu_torch.api import inference, prot_inference\n"
        "from stonkgs_tpu_torch.data import artifacts, fast_tokenizer, masking\n"
        "from stonkgs_tpu_torch.data import preprocessing, prot, transe, wordpiece\n"
        "from stonkgs_tpu_torch.utils import hf_export, hf_loader\n"
        "from stonkgs_tpu_torch.train import finetuning\n"
        "from stonkgs_tpu_torch.cli import finetune\n"
        "from stonkgs_tpu_torch.baselines import kg_baseline, nlp_baseline\n"
        "from stonkgs_tpu_torch.utils import batching, logging\n"
        "from stonkgs_tpu_torch.data import filters, indra_extraction, memmap_dataset\n"
        "from stonkgs_tpu_torch.train import checkpoint, dynamic_masking\n"
        "from stonkgs_tpu_torch.cli import pretrain\n"
        "from stonkgs_tpu_torch.api import api, embeddings\n"
        "from stonkgs_tpu_torch.data import kg_graph, protein_sequences, tsv_io, walker\n"
        "from stonkgs_tpu_torch.models import node2vec, word2vec\n"
        "from stonkgs_tpu_torch.baselines import batteries\n"
        "from stonkgs_tpu_torch.parallel import dryrun, mesh, multihost, tp\n"
        "from stonkgs_tpu_torch import cli, constants, version\n"
        "from stonkgs_tpu_torch.utils import cache, init, parity, profiling\n"
        "from stonkgs_tpu_torch.api import example, get_emmaa\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()
    assert "stonkgs_tpu_torch.api.inference" in out
    assert "stonkgs_tpu_torch.train.finetuning" in out
    assert "stonkgs_tpu_torch.cli.pretrain" in out
    assert "stonkgs_tpu_torch.api.api" in out
    assert "stonkgs_tpu_torch.models.word2vec" in out
    assert "stonkgs_tpu_torch.data.walker" in out
    assert "stonkgs_tpu_torch.data.indra_extraction" in out
    assert "stonkgs_tpu_torch.baselines.batteries" in out
    assert "stonkgs_tpu_torch.parallel.multihost" in out
    assert "stonkgs_tpu_torch.cli" in out and "stonkgs_tpu_torch.utils.parity" in out
    assert "stonkgs_tpu_torch.api.get_emmaa" in out
    assert [m for m in out if m.split(".")[0] in ABSENT_ON_THE_CARD] == []


def test_pandas_only_where_a_task_tsv_is_read():
    """The port imports pandas only inside the functions that read a task
    TSV (``cli/finetune.py::run_finetuning``, the batteries' ``_iter_tasks``,
    ``add_protein_sequences_per_task``), a pickle or a TSV of features
    (``cli/pretrain.py::load_preprocessed_dataset``), write the pickle of
    features (the CLI's ``preprocess``), or take or return DataFrames (the
    serving API of ``api/api.py`` and ``api/embeddings.py``, the EMMAA
    demo's results), and in ``chip_smoke.py`` where phase 22 reads
    the extracted task TSVs; ``data/filters.py`` works on the caller's
    DataFrames without importing it, and the extraction, node2vec and the
    TransE TSV write and read their TSVs with the ``csv`` module."""
    def pandas_imports(node):
        return {id(n) for n in ast.walk(node)
                if (isinstance(n, ast.Import) and any(a.name.split(".")[0] == "pandas"
                                                      for a in n.names))
                or (isinstance(n, ast.ImportFrom) and n.level == 0
                    and n.module.split(".")[0] == "pandas")}

    places = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        found = pandas_imports(tree)
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = pandas_imports(fn) & found
                places += [(str(path.relative_to(ROOT)), fn.name)] * len(inner)
                found -= inner
        places += [(str(path.relative_to(ROOT)), None)] * len(found)
    assert sorted(places) == [
        ("chip_smoke.py", "_no_duplicates_tasks"),
        ("stonkgs_tpu_torch/api/api.py", "_convert_indra_statements"),
        ("stonkgs_tpu_torch/api/api.py", "_prepare_df"),
        ("stonkgs_tpu_torch/api/api.py", "infer_concat"),
        ("stonkgs_tpu_torch/api/embeddings.py", "get_stonkgs_embeddings"),
        ("stonkgs_tpu_torch/api/embeddings.py", "preprocess_df_for_embeddings"),
        ("stonkgs_tpu_torch/api/get_emmaa.py", "run_emmaa_demo"),
        ("stonkgs_tpu_torch/baselines/batteries.py", "_iter_tasks"),
        ("stonkgs_tpu_torch/cli/__init__.py", "_preprocess"),
        ("stonkgs_tpu_torch/cli/finetune.py", "run_finetuning"),
        ("stonkgs_tpu_torch/cli/pretrain.py", "load_preprocessed_dataset"),
        ("stonkgs_tpu_torch/data/protein_sequences.py", "add_protein_sequences_per_task"),
    ]


def _imports_of(node, package):
    return [n for n in ast.walk(node)
            if (isinstance(n, ast.Import) and any(a.name.split(".")[0] == package
                                                  for a in n.names))
            or (isinstance(n, ast.ImportFrom) and n.level == 0
                and n.module.split(".")[0] == package)]


def _import_places(package):
    """(file, enclosing function or None, inside a ``try``) of every
    import of ``package`` in the port and ``chip_smoke.py``."""
    places = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
        for imp in _imports_of(tree, package):
            fn, in_try, node = None, False, imp
            while node in parents:
                node = parents[node]
                in_try = in_try or isinstance(node, ast.Try)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and fn is None:
                    fn = node.name
            places.append((str(path.relative_to(ROOT)), fn, in_try))
    return sorted(places)


def test_optional_packages_only_where_allowed():
    """transformers only inside ``utils/parity.py``'s reference forward;
    matplotlib and seaborn only inside the EMMAA demo's ``try``; click
    nowhere (the CLI is on argparse)."""
    assert _import_places("transformers") == [
        ("stonkgs_tpu_torch/utils/parity.py", "_reference_forward", False)]
    plot = [("stonkgs_tpu_torch/api/get_emmaa.py", "run_emmaa_demo", True)]
    assert _import_places("matplotlib") == plot * 2
    assert _import_places("seaborn") == plot
    assert _import_places("click") == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []
