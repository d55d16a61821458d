"""The port's command line against the JAX package's click CLI, on the CPU.

* Every command and option of ``stonkgs_tpu.cli.main`` has its counterpart
  in the port's parser, with the same name, default, choices and
  requiredness (read from the click commands' ``params``); the port adds
  only ``--device``.
* The commands run with ``--device cpu`` and write what the JAX CLI
  (through ``CliRunner``) writes on the same files: ``extract`` and
  ``preprocess`` byte for byte or array for array, ``node2vec``'s walks
  byte for byte, ``embed`` within 2e-2 (both packages compute in bf16 by
  default, and sum in another order) and byte for byte as the port's
  engine called directly, ``verify-parity`` PASS on both.  Where the two
  packages differ on purpose (``ROADMAP.md`` §C: torch's initial
  parameters, classifier heads and word2vec tables), the command writes
  what the port's own function called directly writes: ``pretrain``
  (every ``--remat`` alike), ``finetune``, ``finetune-all``,
  ``node2vec``'s vectors and ``node2vec-hpo``.
* ``verify-parity`` exits 1 on a fault on the port's side.
"""

import importlib
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner

import jax

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.cli import main as jmain
from stonkgs_tpu.data import artifacts as jart
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.utils import hf_export as jexport
from stonkgs_tpu_torch import cli as tcli
from stonkgs_tpu_torch.api.inference import STonKGsEngine
from stonkgs_tpu_torch.cli import finetune as tfinetune
from stonkgs_tpu_torch.cli import pretrain as tpretrain
from stonkgs_tpu_torch.data import tsv_io
from stonkgs_tpu_torch.models import node2vec as tnode2vec
from stonkgs_tpu_torch.utils import hf_loader

from test_torch_data import bel_names
from test_torch_hf_io import WORDS, bert_vocab
from test_torch_kg_extraction import seeded_corpus, tree_bytes, write_jsonl

ROOT = Path(__file__).resolve().parent.parent
EMBED_TOL = dict(atol=2e-2, rtol=0)
COMMANDS = sorted(jmain.commands)
COMPUTING = {"pretrain", "finetune", "finetune-all", "node2vec", "node2vec-hpo", "embed",
             "verify-parity"}
BERT = jconfig.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=64,
                          max_position_embeddings=32, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
CFG = jconfig.STonKGsConfig(bert=BERT, kg_vocab_size=101, text_len=16, entity_len=16,
                            num_labels=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A checkpoint (JAX init, 3-class classifier), node2vec TSVs of 101
    BEL-named entities with walks of 7, a vocabulary and 24 rows."""
    root = tmp_path_factory.mktemp("cli")
    params = jax.tree.map(np.asarray, jstonkgs.init_stonkgs_params(
        jax.random.PRNGKey(0), CFG, with_classifier=True))
    jexport.save_pretrained(params, CFG, str(root / "ckpt"))
    art = jart.make_random_artifacts(101, dim=32, rw_len=7, seed=1)
    art.names = bel_names(101)
    art.name_to_idx = {n: i for i, n in enumerate(art.names)}
    jart.save_kg_artifacts(art, root / "emb.tsv", root / "walks.tsv")
    (root / "vocab.txt").write_text("\n".join(bert_vocab(128)) + "\n")
    rng = np.random.default_rng(3)
    rows = {"source": [art.names[i] for i in rng.integers(0, 101, 24)],
            "target": [art.names[i] for i in rng.integers(0, 101, 24)],
            "relation": [["increases", "decreases"][i % 2] for i in range(24)],
            "evidence": [" ".join(rng.choice(WORDS[:5], 6)) for _ in range(24)],
            "class": [["up", "down"][i % 2] for i in range(24)]}
    tsv_io.write_table(str(root / "rows.tsv"), rows)
    # TransE embeddings: the entities and the two relations
    with open(root / "transe.tsv", "w") as f:
        for name in art.names + ["increases", "decreases"]:
            f.write(name + "\t" + "\t".join(repr(float(v)) for v in rng.normal(size=32))
                    + "\n")
    return root


def _port(args, capsys=None):
    """The port's CLI in this process: (exit code, printed text)."""
    out = io.StringIO()
    with redirect_stdout(out):
        try:
            rc = tcli.main(args)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def _jax(args):
    result = CliRunner().invoke(jmain, args)
    assert result.exit_code == 0, result.output
    return result.output


def _port_actions(name):
    sub = tcli.build_parser()._subparsers._group_actions[0].choices[name]
    return {a.dest: a for a in sub._actions if a.dest != "help"}


@pytest.mark.parametrize("name", COMMANDS)
def test_every_jax_option_has_a_port_counterpart(name):
    import click

    actions = _port_actions(name)
    jparams = jmain.commands[name].params
    assert len(jparams) > 1
    for p in jparams:
        assert p.name in actions, (name, p.name)
        a = actions[p.name]
        assert set(p.opts) | set(p.secondary_opts) <= set(a.option_strings), (name, p.name)
        # click 8.2+ marks "no default" with a sentinel where argparse has None
        default = None if repr(p.default).startswith("Sentinel.") else p.default
        assert a.default == default, (name, p.name, a.default, p.default)
        assert bool(a.required) == bool(p.required), (name, p.name)
        if isinstance(p.type, click.Choice):
            assert list(a.choices) == list(p.type.choices), (name, p.name)
        if p.is_flag and p.secondary_opts:
            assert isinstance(a, __import__("argparse").BooleanOptionalAction)
    extra = set(actions) - {p.name for p in jparams}
    assert extra == ({"device"} if name in COMPUTING else set()), (name, extra)
    if name in COMPUTING:
        assert actions["device"].default == "cuda"


def test_version_and_the_command_list():
    rc, printed = _port(["--version"])
    assert rc == 0 and printed.strip() == "stonkgs-tpu-torch (dev)"
    assert CliRunner().invoke(jmain, ["--version"]).output.strip() == "stonkgs-tpu (dev)"
    out = subprocess.run([sys.executable, "-m", "stonkgs_tpu_torch", "--help"], cwd=ROOT,
                         check=True, capture_output=True, text=True, timeout=120).stdout
    listed = [c for c in COMMANDS if f"    {c} " in out]
    assert listed == COMMANDS


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_device_cuda_without_a_card_is_refused(files, capsys):
    rc, _ = _port(["embed", "--input", "x", "--model_path", "x", "--kg-embedding-path", "x",
                   "--kg-walks-path", "x", "--vocab-file", "x", "--output", "x"])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err


def _kg(files):
    return ["--kg-embedding-path", str(files / "emb.tsv"),
            "--kg-walks-path", str(files / "walks.tsv")]


@pytest.mark.parametrize("masking", [True, False], ids=["masking", "no-masking"])
def test_embed_matches_jax_cli(files, tmp_path, masking):
    args = ["embed", "--input", str(files / "rows.tsv"), "--model_path", str(files / "ckpt"),
            *_kg(files), "--vocab-file", str(files / "vocab.txt"), "--batch_size", "8"]
    if not masking:
        args.append("--no-masking")
    rc, printed = _port([*args, "--output", str(tmp_path / "port.tsv"), "--device", "cpu"])
    assert rc == 0 and printed == f"wrote 24 embeddings to {tmp_path / 'port.tsv'}\n"
    jprinted = _jax([*args, "--output", str(tmp_path / "jax.tsv")])
    assert jprinted.replace("jax.tsv", "port.tsv") == printed
    got = pd.read_csv(tmp_path / "port.tsv", sep="\t")
    want = pd.read_csv(tmp_path / "jax.tsv", sep="\t")
    assert list(got.columns) == list(want.columns) == ["embedding"]
    g = np.asarray([json.loads(v) for v in got["embedding"]])
    w = np.asarray([json.loads(v) for v in want["embedding"]])
    np.testing.assert_allclose(g, w, **EMBED_TOL)
    # byte for byte what the port's engine gives when called directly
    engine = STonKGsEngine.from_pretrained(str(files / "ckpt"), str(files / "emb.tsv"),
                                           str(files / "walks.tsv"),
                                           vocab_file=str(files / "vocab.txt"), batch_size=8,
                                           device="cpu")
    cols = tsv_io.read_columns(str(files / "rows.tsv"), ("source", "target", "evidence"))
    emb = engine.embed(engine.preprocess(np.asarray(cols["source"], object),
                                         np.asarray(cols["target"], object), cols["evidence"],
                                         apply_masking=masking))
    tsv_io.write_table(str(tmp_path / "direct.tsv"), {"embedding": [r.tolist() for r in emb]})
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "direct.tsv").read_bytes()


@pytest.mark.parametrize("variant", ["stonkgs", "transe"])
def test_preprocess_matches_jax_cli(files, tmp_path, variant):
    emb = files / ("transe.tsv" if variant == "transe" else "emb.tsv")
    args = ["preprocess", "--pretraining_path", str(files / "rows.tsv"),
            "--kg-embedding-path", str(emb), "--kg-walks-path", str(files / "walks.tsv"),
            "--vocab-file", str(files / "vocab.txt"), "--variant", variant, "--seed", "3",
            "--nsp_negative_proportion", "0.5"]
    rc, printed = _port([*args, "--output", str(tmp_path / "port.pkl")])
    assert rc == 0
    jprinted = _jax([*args, "--output", str(tmp_path / "jax.pkl")])
    assert jprinted.replace("jax.pkl", "port.pkl") == printed
    got, want = pd.read_pickle(tmp_path / "port.pkl"), pd.read_pickle(tmp_path / "jax.pkl")
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 24
    for c in want.columns:
        np.testing.assert_array_equal(np.stack(got[c].to_numpy()), np.stack(want[c].to_numpy()),
                                      err_msg=c)


def test_extract_matches_jax_cli(tmp_path):
    raw = tmp_path / "statements.jsonl"
    write_jsonl(raw, seeded_corpus(0))
    rc, printed = _port(["extract", "--path", str(raw), "--output_dir", str(tmp_path / "port")])
    assert rc == 0
    jprinted = _jax(["extract", "--path", str(raw), "--output_dir", str(tmp_path / "jax")])
    assert jprinted.replace(str(tmp_path / "jax"), str(tmp_path / "port")) == printed
    files_ = tree_bytes(tmp_path / "port")
    assert "pretraining/pretraining_triples.tsv" in files_
    assert files_ == tree_bytes(tmp_path / "jax")


def _triples(tmp_path, n=30):
    tsv_io.write_table(str(tmp_path / "triples.tsv"), {
        "source": [f"n{i}" for i in range(n)] + [f"n{i}" for i in range(0, n, 3)],
        "target": [f"n{(i + 1) % n}" for i in range(n)] + [f"n{(i + 7) % n}"
                                                           for i in range(0, n, 3)]})
    return str(tmp_path / "triples.tsv")


def test_node2vec_matches_jax_walks_and_the_port_function(tmp_path):
    triples = _triples(tmp_path)
    args = ["node2vec", "--pretraining_path", triples, "--dimensions", "8",
            "--walk_length", "5", "--epochs", "2", "--n_threads", "1"]
    os.makedirs(tmp_path / "port")
    rc, _ = _port([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert rc == 0
    os.makedirs(tmp_path / "jax")
    _jax([*args, "--output_dir", str(tmp_path / "jax")])
    walks = "random_walks_best_model.tsv"
    assert (tmp_path / "port" / walks).read_bytes() == (tmp_path / "jax" / walks).read_bytes()
    os.makedirs(tmp_path / "direct")
    tnode2vec.run_node2vec(pretraining_path=triples, dimensions=8, walk_length=5, epochs=2,
                           n_threads=1, output_dir=str(tmp_path / "direct"), device="cpu")
    for f in (walks, "embeddings_best_model.tsv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "direct" / f).read_bytes()


def test_node2vec_hpo_prints_the_port_function_result(tmp_path, monkeypatch):
    triples = _triples(tmp_path)
    rc, printed = _port(["node2vec-hpo", "--pretraining_path", triples, "--seed", "1",
                         "--output_dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    want = tnode2vec.run_node2vec_hpo(pretraining_path=triples, seed=1,
                                      output_dir=str(tmp_path), device="cpu")
    assert printed == f"{want}\n"
    assert want["n_trials"] == 1


@pytest.fixture(scope="module")
def features_pkl(files, tmp_path_factory):
    out = tmp_path_factory.mktemp("features") / "features.pkl"
    rc, _ = _port(["preprocess", "--pretraining_path", str(files / "rows.tsv"), *_kg(files),
                   "--vocab-file", str(files / "vocab.txt"), "--output", str(out)])
    assert rc == 0
    return out


def _records(run_dir):
    (log,) = Path(run_dir).glob("*.jsonl")
    return [{k: v for k, v in json.loads(line).items() if k not in ("ts",)}
            for line in log.read_text().splitlines()
            if json.loads(line).get("key") not in ("examples_per_sec", "elapsed_sec", "remat")]


@pytest.mark.parametrize("remat", ["none", "full", "attention"])
def test_pretrain_cli_runs_the_port_function(files, features_pkl, tmp_path, remat):
    """``pretrain`` with each ``--remat`` logs the losses and writes the
    checkpoint of ``run_pretraining`` without remat."""
    args = ["pretrain", "--dataset", str(features_pkl), "--kg-embedding-path",
            str(files / "emb.tsv"), "--vocab-file", str(files / "vocab.txt"),
            "--batch_size", "4", "--max_steps", "2", "--save_steps", "2", "--log_steps", "1",
            "--num_hidden_layers", "2", "--compute_dtype", "float32", "--remat", remat,
            "--output_dir", str(tmp_path / "cli"), "--device", "cpu"]
    rc, _ = _port(args)
    assert rc == 0
    tpretrain.run_pretraining(
        str(features_pkl), kg_embedding_path=str(files / "emb.tsv"),
        vocab_file=str(files / "vocab.txt"), batch_size=4, max_steps=2, save_steps=2,
        log_steps=1, num_hidden_layers=2, compute_dtype="float32", remat="none",
        output_dir=str(tmp_path / "direct"), device="cpu")
    got, want = _records(tmp_path / "cli"), _records(tmp_path / "direct")
    assert [r["key"] for r in got if r["type"] == "metric"].count("loss") == 2
    assert [r for r in got if r["type"] == "metric"] == [r for r in want
                                                        if r["type"] == "metric"]
    ckpt = lambda d: sorted(os.listdir(tmp_path / d / "checkpoints"))  # noqa: E731
    assert ckpt("cli") == ckpt("direct") == ["2"]
    a = torch.load(next((tmp_path / "cli" / "checkpoints" / "2").glob("*.pt")))
    b = torch.load(next((tmp_path / "direct" / "checkpoints" / "2").glob("*.pt")))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a if isinstance(a[k], torch.Tensor))


def _task_args(files):
    return ["--model_path", str(files / "ckpt"), *_kg(files), "--vocab-file",
            str(files / "vocab.txt"), "-e", "1", "--cv", "2", "--lr", "1e-3",
            "--batch_size", "4"]


def test_finetune_cli_runs_the_port_function(files, tmp_path):
    rc, _ = _port(["finetune", "--train_data_path", str(files / "rows.tsv"),
                   *_task_args(files), "--task_name", "toy", "--output_dir",
                   str(tmp_path / "cli"), "--device", "cpu"])
    assert rc == 0
    want = tfinetune.run_finetuning(
        str(files / "rows.tsv"), str(files / "ckpt"), str(files / "emb.tsv"),
        str(files / "walks.tsv"), str(files / "vocab.txt"), epochs=1, cv=2, lr=1e-3,
        batch_size=4, task_name="toy", output_dir=str(tmp_path / "direct"), device="cpu")
    assert 0.0 <= want["f1_score_mean"] <= 1.0
    tsv = "predicted_labels_stonkgs_toydf.tsv"
    assert (tmp_path / "cli" / tsv).read_bytes() == (tmp_path / "direct" / tsv).read_bytes()


def test_finetune_all_prints_each_task(files, tmp_path):
    task_dir = tmp_path / "tasks" / "species"
    task_dir.mkdir(parents=True)
    (task_dir / "species_ppi_prot.tsv").write_bytes((files / "rows.tsv").read_bytes())
    rc, printed = _port(["finetune-all", "--input_dir", str(tmp_path / "tasks"),
                         *_task_args(files), "--output_dir", str(tmp_path / "cli"),
                         "--device", "cpu"])
    assert rc == 0
    want = tfinetune.run_all_fine_tuning_tasks(
        str(tmp_path / "tasks"), model_path=str(files / "ckpt"),
        kg_embedding_path=str(files / "emb.tsv"), kg_walks_path=str(files / "walks.tsv"),
        vocab_file=str(files / "vocab.txt"), epochs=1, cv=2, lr=1e-3, batch_size=4,
        output_dir=str(tmp_path / "direct"), device="cpu")
    assert list(want) == ["species"]
    res = want["species"]
    summary = [ln for ln in printed.splitlines() if not ln.startswith('{"type"')]  # run logs
    assert summary == [f"species: f1 {res['f1_score_mean']:.4f} ± {res['f1_score_std']:.4f}"]


def test_verify_parity_passes_as_the_jax_cli_and_rejects_a_fault(files, monkeypatch):
    args = ["verify-parity", "--model_path", str(files / "ckpt"), *_kg(files),
            "--n_rows", "2", "--tolerance", "1e-3"]
    rc, printed = _port([*args, "--device", "cpu"])
    assert rc == 0 and printed.startswith("PASS") and "cls " in printed
    assert _jax(args).startswith("PASS")
    load = hf_loader.stonkgs_params_from_state_dict

    def shifted(*a, **kw):          # a fault on the port's side only
        p = load(*a, **kw)
        p["cls"]["seq_relationship"]["bias"] += 1e-2
        return p

    monkeypatch.setattr(hf_loader, "stonkgs_params_from_state_dict", shifted)
    rc, printed = _port([*args, "--device", "cpu"])
    assert rc == 1 and printed.startswith("FAIL") and "nsp 1.00e-02" in printed


def test_module_entry_point_runs_a_command(files, tmp_path):
    """``python -m stonkgs_tpu_torch`` in a fresh process: the exit code
    of ``verify-parity`` at a tolerance the run cannot meet is 1."""
    out = subprocess.run(
        [sys.executable, "-m", "stonkgs_tpu_torch", "verify-parity", "--model_path",
         str(files / "ckpt"), *_kg(files), "--n_rows", "2", "--tolerance", "0",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout.startswith("FAIL"), out.stderr[-2000:]


def test_jax_pretrain_module_is_not_the_command():
    """The JAX package's ``cli.pretrain`` names a click command; the module
    is reached with ``importlib`` (the port's is a module)."""
    assert importlib.import_module("stonkgs_tpu.cli.pretrain").run_pretraining
    assert tpretrain.run_pretraining
