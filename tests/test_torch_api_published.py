"""The published-model API from a cache filled here, with no network, on the CPU.

Both packages' caches point at one directory in ``tmp_path`` holding, at
the paths their ``ensure`` maps the published URLs to, golden checkpoints
(``tests/torch_golden.py``) for the species (3 classes) and the correct
(binary) records, a checkpoint without a classifier for the hub's
``stonkgs/stonkgs-150k``, the node2vec TSVs and a vocabulary;
``urllib.request.urlretrieve`` fails if reached.  The engines of both
packages are held to fp32 here (their published default is bf16, where
the two frameworks round differently), so ``infer_species``,
``infer_correct_binary`` and ``from_default_pretrained`` agree within
1e-5.  ``run_emmaa_demo`` and ``example.main`` run offline, mirroring
``tests/test_emmaa_example.py``.
"""

import gzip
import json
import pickle
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from stonkgs_tpu.api import api as japi
from stonkgs_tpu.api import inference as jinf
from stonkgs_tpu.utils import cache as jcache
from stonkgs_tpu_torch.api import api as tapi
from stonkgs_tpu_torch.api import example, get_emmaa
from stonkgs_tpu_torch.api import inference as tinf
from stonkgs_tpu_torch.constants import EMBEDDINGS_URL, VOCAB_URL, WALKS_URL
from stonkgs_tpu_torch.data.artifacts import KGArtifacts, save_kg_artifacts
from stonkgs_tpu_torch.utils import cache as tcache

from torch_golden import GoldenSTonKGs

TOL = dict(atol=1e-5, rtol=0)
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=64, type_vocab_size=2)
KG_VOCAB, RW_LEN, TEXT_LEN = 110, 15, 32
VOCAB = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "akt1", "mtor", "gsk3b", "activates", "inhibits", "binds"]
NODE_NAMES = ["p(HGNC:391 ! AKT1)", "p(HGNC:3942 ! MTOR)", "p(HGNC:4617 ! GSK3B)"]
NAMES = NODE_NAMES + [f"node{i}" for i in range(KG_VOCAB - len(NODE_NAMES))]
ROWS = [[NAMES[0], NAMES[1], "akt1 activates mtor"],
        [NAMES[2], NAMES[1], "gsk3b inhibits mtor"],
        [NAMES[5], NAMES[7], "binds akt1"],
        ["p(HGNC:1 ! NOT_IN_KG)", NAMES[3], "mtor binds gsk3b"]]


def _write_checkpoint(directory, num_labels, seed):
    golden = GoldenSTonKGs(TINY, KG_VOCAB, TEXT_LEN, num_labels=num_labels, seed=seed)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(golden.reference_state_dict(), directory / "pytorch_model.bin")
    (directory / "config.json").write_text(json.dumps({**TINY, "num_labels": num_labels}))
    return golden


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")

    def path(url, sub=""):
        return root / sub / url.rsplit("/", 1)[-1]

    for sub, record, labels, seed in (("species", tapi.SPECIES_RECORD, 3, 0),
                                      ("correct_binary", tapi.CORRECT_BINARY_RECORD, 2, 1)):
        base = f"https://zenodo.org/record/{record}/files"
        golden = _write_checkpoint(path(f"{base}/pytorch_model.bin", sub).parent, labels, seed)
        path(f"{base}/training_args.bin", sub).write_bytes(b"\0")
    _write_checkpoint(root / "hub" / "stonkgs--stonkgs-150k", None, 0)
    rng = np.random.default_rng(0)
    art = KGArtifacts(names=NAMES, name_to_idx={n: i for i, n in enumerate(NAMES)},
                      vectors=golden.kg_vectors,
                      walk_indices=rng.integers(0, KG_VOCAB, (KG_VOCAB, RW_LEN), dtype=np.int32),
                      rw_len=RW_LEN)
    save_kg_artifacts(art, path(EMBEDDINGS_URL), path(WALKS_URL))
    path(VOCAB_URL, "misc").parent.mkdir(parents=True, exist_ok=True)
    path(VOCAB_URL, "misc").write_text("\n".join(VOCAB) + "\n")
    return root


def _fp32(monkeypatch, module):
    """Hold ``module.STonKGsEngine.from_pretrained`` to fp32 engines."""
    engine = module.STonKGsEngine
    load = engine.from_pretrained.__func__
    monkeypatch.setattr(engine, "from_pretrained", classmethod(
        lambda cls, *a, **kw: load(cls, *a, **{**kw, "compute_dtype": "float32"})))


@pytest.fixture
def offline(cache_dir, monkeypatch):
    """Both caches on ``cache_dir``, no network, fresh model caches."""
    reached = []

    def no_network(url, *a, **kw):
        reached.append(url)
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(tcache, "CACHE_DIR", cache_dir)
    monkeypatch.setattr(jcache, "CACHE_DIR", cache_dir)
    for mod in (tapi, japi):
        for fn in (mod.get_species_model, mod.get_correct_binary_model):
            fn.cache_clear()
    yield reached
    for mod in (tapi, japi):
        for fn in (mod.get_species_model, mod.get_correct_binary_model):
            fn.cache_clear()
    assert reached == []


def _probs(rows, n_classes):
    header, *data = list(rows)
    return header, np.asarray([r[-n_classes:] for r in data], np.float64), data


@pytest.mark.parametrize("task, columns", [
    ("infer_species", tapi.SPECIES_COLUMNS),
    ("infer_correct_binary", tapi.CORRECT_BINARY_COLUMNS),
], ids=["species", "correct_binary"])
def test_infer_task_matches_jax_from_the_cache(offline, monkeypatch, task, columns):
    _fp32(monkeypatch, tinf)
    _fp32(monkeypatch, jinf)
    header, got, rows = _probs(getattr(tapi, task)(ROWS, device="cpu"), len(columns))
    jheader, want, jrows = _probs(getattr(japi, task)(ROWS), len(columns))
    assert header == jheader == ("source", "target", "evidence", *columns)
    assert [r[:3] for r in rows] == [tuple(r) for r in ROWS] == [r[:3] for r in jrows]
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, **TOL)
    model = tapi.get_species_model("cpu") if task == "infer_species" else \
        tapi.get_correct_binary_model("cpu")
    assert model.device.type == "cpu" and model.cfg.num_labels == len(columns)


def test_published_lists_match_jax():
    for name in dir(japi):
        if name.endswith(("_RECORD", "_COLUMNS")):
            assert getattr(tapi, name) == getattr(japi, name), name
    ensure_fns = sorted(n for n in dir(japi) if n.startswith(("ensure_", "get_", "infer_")))
    assert [n for n in ensure_fns if not hasattr(tapi, n)] == []


def test_ensure_functions_return_the_cached_paths(offline, cache_dir):
    assert tapi.ensure_walks() == japi.ensure_walks() == cache_dir / "random_walks_best_model.tsv"
    assert tapi.ensure_embeddings() == japi.ensure_embeddings()
    assert tapi.ensure_vocab() == japi.ensure_vocab() == cache_dir / "misc" / "vocab.txt"
    assert tapi.ensure_species() == japi.ensure_species() == (
        cache_dir / "species" / "pytorch_model.bin")
    with pytest.raises(RuntimeError, match="location"):
        tapi.ensure_location()          # not in the cache, and no network
    offline.clear()


def test_default_dtype_infer_species_sums_to_one(offline):
    """The published path as it ships (bf16 on the engine's device)."""
    header, probs, _ = _probs(tapi.infer_species(ROWS, device="cpu"), 3)
    assert tapi.get_species_model("cpu").compute_dtype == "bfloat16"
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)
    assert np.isfinite(probs).all() and probs.shape == (len(ROWS), 3)


def test_from_default_pretrained_matches_jax(offline):
    got = tinf.STonKGsEngine.from_default_pretrained(device="cpu", compute_dtype="float32")
    want = jinf.STonKGsEngine.from_default_pretrained(compute_dtype="float32")
    assert got.cfg.num_labels is None and "classifier" not in got.params
    src, tgt, ev = (list(c) for c in zip(*ROWS))
    feats = got.preprocess(src, tgt, ev)
    jfeats = want.preprocess(np.asarray(src, object), np.asarray(tgt, object), ev)
    for k in jfeats:
        np.testing.assert_array_equal(feats[k], np.asarray(jfeats[k]), err_msg=k)
    np.testing.assert_allclose(got.embed(feats), np.asarray(want.embed(jfeats)), **TOL)


def _statement(stype, a, b, belief, text, matches_hash):
    key = {"Activation": ("subj", "obj"), "Inhibition": ("subj", "obj"),
           "Phosphorylation": ("enz", "sub")}[stype]
    return {"type": stype, key[0]: a, key[1]: b, "belief": belief,
            "matches_hash": matches_hash, "evidence": [{"text": text, "pmid": "1"}]}


def _agent(name, ident):
    return {"name": name, "db_refs": {"HGNC": ident, "TEXT": name.lower()}}


def test_run_emmaa_demo_offline(offline, tmp_path, monkeypatch):
    statements = [
        _statement("Activation", _agent("AKT1", "391"), _agent("MTOR", "3942"),
                   0.95, "AKT1 activates MTOR.", "111"),
        _statement("Inhibition", _agent("GSK3B", "4617"), _agent("MTOR", "3942"),
                   0.10, "GSK3B inhibits MTOR.", "222"),
        _statement("Phosphorylation", _agent("AKT1", "391"), _agent("GSK3B", "4617"),
                   0.50, "AKT1 phosphorylates GSK3B.", "333"),
    ]
    _fp32(monkeypatch, tinf)
    _fp32(monkeypatch, jinf)
    results = {}
    for name, mod in (("port", get_emmaa), ("jax", __import__(
            "stonkgs_tpu.api.get_emmaa", fromlist=["x"]))):
        gz = tmp_path / name / "statements_test.gz"
        gz.parent.mkdir()
        with gzip.open(gz, "wt") as f:
            json.dump(statements, f)
        monkeypatch.setattr(mod, "ensure", lambda url, sub, gz=gz: gz)
        kw = {"device": "cpu"} if name == "port" else {}
        results[name] = mod.run_emmaa_demo(
            url="https://example.org/assembled/test/statements_test.gz", **kw)
    results_path, curation_path = results["port"]
    df = pd.read_csv(results_path, sep="\t", dtype={"stmt_hash": str})
    jdf = pd.read_csv(results["jax"][0], sep="\t", dtype={"stmt_hash": str})
    assert list(df.columns) == list(jdf.columns) == [
        "stmt_hash", "belief", "source", "target", "evidence", "incorrect", "correct"]
    assert len(df) == 3
    probs = df[["incorrect", "correct"]].to_numpy()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs, jdf[["incorrect", "correct"]].to_numpy(), **TOL)
    with open(curation_path, "rb") as f:
        curated = pickle.load(f)
    expected = get_emmaa.select_curation_candidates(df[["stmt_hash", "belief", "correct"]])
    assert {s["matches_hash"] for s in curated} == expected
    assert (tmp_path / "port" / "statements_test.scatter.svg").exists() == \
        (tmp_path / "jax" / "statements_test.scatter.svg").exists()


def test_select_curation_candidates_quadrants():
    df = pd.DataFrame({"stmt_hash": [str(i) for i in range(6)],
                       "belief": [0.1, 0.1, 0.9, 0.9, 0.5, 0.1],
                       "correct": [0.1, 0.9, 0.1, 0.9, 0.1, 0.5]})
    assert get_emmaa.select_curation_candidates(df) == {"0", "1", "2", "3"}


def test_api_example_offline(offline, tmp_path, monkeypatch, capsys):
    out_path = tmp_path / "species" / "predictions.tsv"
    monkeypatch.setattr(example, "SPECIES_PREDICTION_PATH", out_path)
    example.main(device="cpu")
    df = pd.read_csv(out_path, sep="\t")
    assert list(df.columns) == ["source", "target", "evidence", "mouse", "rat", "human"]
    assert len(df) == len(example.EXAMPLE_ROWS)
    np.testing.assert_allclose(df[["mouse", "rat", "human"]].to_numpy().sum(1), 1.0, atol=1e-5)
    assert f"Results at {out_path}" in capsys.readouterr().out
