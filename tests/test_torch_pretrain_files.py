"""The port's pre-training from files against the JAX package, on the CPU.

Every file is written in ``tmp_path``: feature pickles and TSVs, memmap
stores, node2vec TSVs and checkpoints.  Then:

* input: ``load_preprocessed_dataset`` (pickle, TSV with stringified
  lists, memmap store), ``MemmapFeatureStore`` (the same ``.npy`` bytes and
  ``meta.json``), ``memmap_data_iterator`` (the same batches) and every
  ``data/filters.py`` function (the same DataFrames; ``reduce_dataset_size``
  keeps scikit-learn's rows) equal to the JAX package's;
* the configs ``run_pretraining`` derives, field for field;
* ``pretrain`` with checkpoints, stopped at step 2 and resumed to 4: its
  losses match the JAX ``pretrain`` run without a stop to rtol 1e-5 and its
  parameters to atol 1e-5, as ``tests/test_torch_train.py`` holds one step
  (dropout 0, fp32); with the dropouts on, the resumed run equals the
  uninterrupted one bit for bit;
* ``CheckpointManager``: rotation, an interrupted save ignored, a
  non-blocking save durable after ``wait()`` and holding its own step's
  state, the error on a mismatched tree;
* ``run_pretraining`` end to end with a resume, as
  ``tests/test_cli_api.py::test_cli_pretrain_driver`` runs the JAX one;
* ``mask_tokens_torch`` and ``dynamic_masking_loss`` by their statistics
  (``jax.random`` cannot be matched draw for draw) and ``dynamic_nsp_swap``
  by the properties ``tests/test_dynamic_masking.py`` checks.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu.data import filters as jfilters
from stonkgs_tpu.data import memmap_dataset as jmem
from stonkgs_tpu.models import protstonkgs as jprot
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.train import pretraining as jpre
from stonkgs_tpu_torch.cli import pretrain as tcli
from stonkgs_tpu_torch.data import filters as tfilters
from stonkgs_tpu_torch.data import memmap_dataset as tmem
from stonkgs_tpu_torch.data.masking import IGNORE_INDEX, mask_tokens_torch
from stonkgs_tpu_torch.models import protstonkgs as tprot
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.train import checkpoint as tckpt
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.train.dynamic_masking import dynamic_masking_loss, dynamic_nsp_swap
from stonkgs_tpu_torch.train.optimizer import AdamW
from stonkgs_tpu_torch.utils.convert import params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves

from test_torch_train import CFG, features, port_cfg

TCFG = port_cfg(CFG)
# the module, not the click command that ``stonkgs_tpu.cli`` names "pretrain"
jcli = importlib.import_module("stonkgs_tpu.cli.pretrain")


def _jax_params(cfg=CFG, seed=0):
    p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(seed), cfg)
    p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                         (cfg.kg_table_size, cfg.bert.hidden_size))
    return jax.tree.map(np.asarray, p)


def _arrays_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# input files
# ---------------------------------------------------------------------------

def _write_dataset(fmt: str, root, feats: dict) -> str:
    if fmt == "memmap":
        jmem.MemmapFeatureStore.write(str(root / "store"), feats)
        return str(root / "store")
    df = pd.DataFrame({k: [r.tolist() for r in v] if v.ndim > 1 else v
                       for k, v in feats.items()})
    if fmt == "pickle":
        df.to_pickle(root / "feats.pkl")
        return str(root / "feats.pkl")
    df.to_csv(root / "feats.tsv", sep="\t", index=False)   # lists become strings
    return str(root / "feats.tsv")


@pytest.mark.parametrize("fmt", ["pickle", "tsv", "memmap"])
def test_load_preprocessed_dataset_matches_jax(tmp_path, fmt):
    path = _write_dataset(fmt, tmp_path, features(CFG, 6, seed=1))
    _arrays_equal(tcli.load_preprocessed_dataset(path), jcli.load_preprocessed_dataset(path))


def _store_files(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("how", ["write", "convert_chunked"])
def test_memmap_store_files_match_jax(tmp_path, how):
    feats = features(CFG, 10, seed=2)
    for pkg, name in ((tmem, "port"), (jmem, "jax")):
        cls = pkg.MemmapFeatureStore
        if how == "write":
            cls.write(str(tmp_path / name), feats)
        else:
            cls.convert_chunked(str(tmp_path / name), (
                {k: v[i: i + 4] for k, v in feats.items()} for i in range(0, 10, 4)))
    got, want = _store_files(tmp_path / "port"), _store_files(tmp_path / "jax")
    assert got.keys() == want.keys() and "meta.json" in got
    assert got == want
    store = tmem.MemmapFeatureStore(str(tmp_path / "port"))
    assert len(store) == 10 and set(store.keys()) == set(feats)
    _arrays_equal({k: store[k] for k in store.keys()},
                  {k: v.astype(np.int32) for k, v in feats.items()})


def test_memmap_data_iterator_matches_jax(tmp_path):
    jmem.MemmapFeatureStore.write(str(tmp_path / "s"), features(CFG, 11, seed=3))
    t_it = tmem.memmap_data_iterator(tmem.MemmapFeatureStore(str(tmp_path / "s")), 4, seed=5)
    j_it = jmem.memmap_data_iterator(jmem.MemmapFeatureStore(str(tmp_path / "s")), 4, seed=5)
    for _ in range(7):     # past two epochs of two batches
        _arrays_equal(next(t_it), next(j_it))
    with pytest.raises(ValueError, match="batch_size"):
        next(tmem.memmap_data_iterator(tmem.MemmapFeatureStore(str(tmp_path / "s")), 12))


def _task_df(n=240, seed=0):
    rng = np.random.default_rng(seed)
    ents = [f"p(HGNC:{i} ! G{i})" for i in range(30)]
    return pd.DataFrame({
        "source": rng.choice(ents, n), "target": rng.choice(ents, n),
        "evidence": [f"ev [XREF_BIBR] {i % 190} \\u03b1 " + "w " * int(rng.integers(0, 60))
                     for i in range(n)],
        "class": rng.choice(["a", "b", "b", "c", "-1", "EFO:0000887", "d", "e"], n),
        "interaction": rng.choice(["direct", "indirect"], n),
        "polarity": rng.choice(["up", "down", "down"], n),
    })


class _SplitTokenizer:
    def tokenize(self, text):
        return text.split()


FILTER_CASES = {
    "filter_out_duplicates": lambda f, df: f.filter_out_duplicates(df, "t"),
    "apply_kg_filtering": lambda f, df: f.apply_kg_filtering(
        df, {f"p(HGNC:{i} ! G{i})" for i in range(20)}, "t"),
    "reduce_dataset_size": lambda f, df: f.reduce_dataset_size(df, 50, random_seed=7),
    "reduce_dataset_size_relation_type": lambda f, df: f.reduce_dataset_size(
        df, 40, class_name="interaction", name="relation_type"),
    "reduce_dataset_size_small": lambda f, df: f.reduce_dataset_size(df, 1000),
    "filter_out_special_character_sequences": lambda f, df:
        f.filter_out_special_character_sequences(df, _SplitTokenizer(), min_tokens=20),
    "filter_for_majority_classes": lambda f, df: f.filter_for_majority_classes(df, 3),
    "fix_stringified_lists": lambda f, df: f.fix_stringified_lists(
        pd.DataFrame({"input_ids": ["[1, 2, 3]", "[4, 5, 6]"], "other": ["x", "y"]})),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filters_match_jax(case):
    fn = FILTER_CASES[case]
    got, want = fn(tfilters, _task_df()), fn(jfilters, _task_df())
    pd.testing.assert_frame_equal(got, want)


def test_filters_set_functions_match_jax():
    df = _task_df()
    assert tfilters.load_entities(df) == jfilters.load_entities(df)
    pre, fine = {"a", "b", "c"}, {"t1": {"a", "d"}, "t2": {"e", "f", "b"}}
    assert tfilters.find_missing_entities(pre, fine) == jfilters.find_missing_entities(pre, fine)
    assert (tfilters.find_information_leakage(pre, fine)
            == jfilters.find_information_leakage(pre, fine))
    assert tfilters.MAJORITY_CLASS_COUNTS == jfilters.MAJORITY_CLASS_COUNTS


# ---------------------------------------------------------------------------
# the configs run_pretraining derives
# ---------------------------------------------------------------------------

class _Captured(Exception):
    def __init__(self, cfg):
        self.cfg = cfg


def _capture(monkeypatch, module, name):
    def capture(_key, cfg, *a, **kw):
        raise _Captured(cfg)
    monkeypatch.setattr(module, name, capture)


def _prot_features(n, text_len, ent_len, prot_len, seed=0):
    rng = np.random.default_rng(seed)
    S = text_len + ent_len + prot_len
    return {"input_ids": np.concatenate([rng.integers(0, 120, (n, text_len)),
                                         rng.integers(0, 90, (n, ent_len)),
                                         rng.integers(0, 25, (n, prot_len))], 1),
            "attention_mask": np.ones((n, S), np.int64),
            "masked_lm_labels": np.full((n, text_len), -100),
            "ent_masked_lm_labels": np.full((n, ent_len), -100),
            "prot_masked_lm_labels": np.full((n, prot_len), -100)}


def _write_vectors(path, n, dim, seed=0):
    vecs = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    with open(path, "w") as f:
        for i, v in enumerate(vecs):
            f.write(f"node{i}\t" + "\t".join(repr(float(x)) for x in v) + "\n")
    return str(path)


@pytest.mark.parametrize("variant", ["stonkgs", "transe", "prot"])
@pytest.mark.parametrize("dim", [32, 768])
def test_derived_configs_match_jax(tmp_path, monkeypatch, variant, dim):
    if variant == "prot":
        feats = _prot_features(2, 48, 16, 64)
        _capture(monkeypatch, jprot, "init_protstonkgs_params")
        _capture(monkeypatch, tprot, "init_protstonkgs_params")
    else:
        feats = features(CFG, 2) if variant == "stonkgs" else {
            k: v[:, :20] if v.ndim > 1 else v for k, v in features(CFG, 2).items()}
        _capture(monkeypatch, jstonkgs, "init_stonkgs_params")
        _capture(monkeypatch, tstonkgs, "init_stonkgs_params")
    path = _write_dataset("pickle", tmp_path, feats)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(f"w{i}" for i in range(77)) + "\n")
    kw = dict(variant=variant, kg_embedding_path=_write_vectors(tmp_path / "e.tsv", 5, dim),
              vocab_file=str(vocab), output_dir=str(tmp_path / "run"))
    with pytest.raises(_Captured) as got:
        tcli.run_pretraining(path, device="cpu", **kw)
    with pytest.raises(_Captured) as want:
        jcli.run_pretraining(path, **kw)
    assert dataclasses.asdict(got.value.cfg) == dataclasses.asdict(want.value.cfg)


def test_run_pretraining_raises_for_the_mesh_and_without_cuda(tmp_path, monkeypatch):
    """In one process ``fsdp`` runs (there is no data axis to split over)
    and ``n_model_shards=2`` asks for a torchrun launch; the two-rank run
    is in ``test_torch_parallel.py``.  Without CUDA the default raises."""
    path = _write_dataset("pickle", tmp_path, features(CFG, 4))
    with pytest.raises(ValueError, match="torchrun"):
        tcli.run_pretraining(path, n_model_shards=2, device="cpu")
    emb = _write_vectors(tmp_path / "emb.tsv", CFG.kg_vocab_size, 32)
    state = tcli.run_pretraining(path, fsdp=True, device="cpu", kg_embedding_path=emb,
                                 batch_size=4, max_steps=1, compute_dtype="float32",
                                 output_dir=str(tmp_path / "run"))
    assert state.step == 1 and state.layout is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.run_pretraining(path)


# ---------------------------------------------------------------------------
# pretrain with checkpoints
# ---------------------------------------------------------------------------

def _port_run(params_np, cfg, feats, ckpt_dir, steps, dropout=0.0, **run):
    tcfg = port_cfg(cfg.replace(bert=dataclasses.replace(
        cfg.bert, hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)))
    logged = []
    run_cfg = tpre.PretrainingConfig(max_steps=steps, micro_batch_size=4, log_steps=1,
                                     compute_dtype="float32", seed=3, **run)
    state = tpre.pretrain(tcfg, params_from_jax(params_np, tcfg), feats, run_cfg,
                          checkpoint_dir=ckpt_dir, log_fn=lambda s, m: logged.append((s, m)))
    return state, logged


def test_pretrain_resume_matches_jax(tmp_path):
    """Stop at step 2, resume to 4: losses and parameters of the JAX run
    that never stopped (dropout 0, fp32)."""
    params = _jax_params()
    feats = features(CFG, 12, seed=4)
    jlogged = []
    jrun = jpre.PretrainingConfig(max_steps=4, micro_batch_size=4, log_steps=1,
                                  compute_dtype="float32", seed=3)
    jstate = jpre.pretrain(CFG, jax.tree.map(jnp.asarray, params), feats, jrun,
                           log_fn=lambda s, m: jlogged.append((s, m)))
    ckpt = str(tmp_path / "ckpt")
    first, logged1 = _port_run(params, CFG, feats, ckpt, 4, stop_at_step=2)
    assert first.step == 2 and [s for s, _ in logged1] == [1, 2]
    assert tckpt.CheckpointManager(ckpt).steps() == [2]
    state, logged2 = _port_run(params, CFG, feats, ckpt, 4)
    assert state.step == 4 and state.opt_state["count"] == 4
    assert [s for s, _ in logged2] == [3, 4]
    assert "examples_per_sec" in logged2[-1][1]
    for (s, m), (js, jm) in zip(logged1 + logged2, jlogged):
        assert s == js
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5, err_msg=f"step {s}")
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), TCFG)
    got, exp = tree_flatten_with_path(state.params), tree_flatten_with_path(want)
    assert got.keys() == exp.keys()
    for k in exp:
        np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_resumed_run_equals_uninterrupted_with_dropout(tmp_path):
    params = _jax_params()
    feats = features(CFG, 12, seed=5)   # 3 steps an epoch: the resume crosses one
    full, full_log = _port_run(params, CFG, feats, str(tmp_path / "a"), 5, dropout=0.1,
                               save_steps=2)
    _port_run(params, CFG, feats, str(tmp_path / "b"), 5, dropout=0.1, stop_at_step=3)
    resumed, res_log = _port_run(params, CFG, feats, str(tmp_path / "b"), 5, dropout=0.1)
    assert [s for s, _ in res_log] == [4, 5]
    assert [m["loss"] for _, m in res_log] == [m["loss"] for _, m in full_log[3:]]
    a, b = tree_flatten_with_path(full.params), tree_flatten_with_path(resumed.params)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tckpt.CheckpointManager(str(tmp_path / "a")).steps() == [2, 4, 5]


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"trunk": {"w": torch.randn(8, 8, generator=g), "b": [torch.randn(3, generator=g)]},
              "lm_backbone": {"w": torch.randn(4, 4, generator=g).bfloat16()}}
    tx = AdamW(learning_rate=1e-3, total_steps=10)
    return tpre.init_train_state(params, tx, seed=seed), tx


def test_checkpoint_rotation_and_restore(tmp_path):
    state, tx = _tiny_state()
    mngr = tckpt.CheckpointManager(str(tmp_path), save_total_limit=2)
    assert mngr.latest_step() is None and mngr.restore_latest(state) is None
    leaves = tree_leaves(tpre.split_frozen(state.params)[0])
    for step in (1, 2, 3, 4):
        tx.update_and_apply([torch.ones_like(t) for t in leaves], state.opt_state, leaves)
        state.step = step
        mngr.save(step, state)
    assert mngr.steps() == [3, 4] and sorted(os.listdir(tmp_path)) == ["3", "4"]
    fresh, _ = _tiny_state(seed=1)
    back = tckpt.CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert back.step == 4 and back.seed == 0 and back.opt_state["count"] == 4
    for tree in ("params", "opt_state"):
        got = tree_flatten_with_path(getattr(back, tree))
        want = tree_flatten_with_path(getattr(state, tree))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k] if k == "count" else torch.equal(got[k], want[k])
    assert back.params["lm_backbone"]["w"].dtype == torch.bfloat16
    with open(tmp_path / "4" / "state.json") as f:
        assert json.load(f) == {"step": 4, "seed": 0, "count": 4}


def test_restore_ignores_interrupted_tmp_dir(tmp_path):
    state, _ = _tiny_state()
    mngr = tckpt.CheckpointManager(str(tmp_path), save_total_limit=3)
    mngr.save(2, state)
    fake = tmp_path / "4.tmp"      # a run killed while it wrote step 4
    fake.mkdir()
    (fake / "tensors.pt").write_text("interrupted")
    (tmp_path / "6").mkdir()       # a directory without its state file
    mngr2 = tckpt.CheckpointManager(str(tmp_path), save_total_limit=3)
    assert mngr2.latest_step() == 2
    assert mngr2.restore_latest(state).step == 2
    mngr2.save(4, state)
    assert mngr2.latest_step() == 4 and not fake.exists()


def test_async_save_holds_its_step_while_the_next_updates_in_place(tmp_path):
    state, tx = _tiny_state()
    state.step = 1
    before = {k: v.clone() for k, v in tree_flatten_with_path(state.params).items()}
    mngr = tckpt.CheckpointManager(str(tmp_path))
    mngr.save(1, state, blocking=False)
    leaves = tree_leaves(tpre.split_frozen(state.params)[0])
    tx.update_and_apply([torch.ones_like(t) for t in leaves], state.opt_state, leaves)
    state.params["lm_backbone"]["w"].add_(1)
    mngr.wait()
    assert mngr.latest_step() == 1
    fresh, _ = _tiny_state(seed=2)
    back = mngr.restore_latest(fresh)
    assert back.opt_state["count"] == 0
    got = tree_flatten_with_path(back.params)
    assert all(torch.equal(got[k], before[k]) for k in before)
    assert not torch.equal(got["trunk/w"], state.params["trunk"]["w"])


def test_restore_raises_on_a_mismatched_tree(tmp_path):
    state, _ = _tiny_state()
    tckpt.CheckpointManager(str(tmp_path)).save(1, state)
    other, _ = _tiny_state()
    other.params["trunk"]["w"] = torch.zeros(8, 9)
    other.params["cls"] = {"x": torch.zeros(2)}
    with pytest.raises(ValueError, match=r"does not match.*trunk/w.*\(8, 8\).*\(8, 9\)"):
        tckpt.CheckpointManager(str(tmp_path)).restore_latest(other)
    bf, _ = _tiny_state()
    bf.params["lm_backbone"]["w"] = bf.params["lm_backbone"]["w"].float()
    with pytest.raises(ValueError, match="lm_backbone/w.*bfloat16.*float32"):
        tckpt.CheckpointManager(str(tmp_path)).restore_latest(bf)


# ---------------------------------------------------------------------------
# run_pretraining end to end
# ---------------------------------------------------------------------------

def _jsonl_steps(output_dir):
    steps = []
    for name in sorted(os.listdir(output_dir)):
        if name.endswith(".jsonl"):
            with open(os.path.join(output_dir, name)) as f:
                steps += [r["step"] for r in map(json.loads, f) if r.get("key") == "loss"]
    return steps


def test_run_pretraining_resumes(tmp_path):
    """From a pickle, 3 steps, then 5 in a second call that resumes; the
    memmap store trains the same as the pickle it was written from."""
    feats = features(CFG, 12, seed=6)
    pkl = _write_dataset("pickle", tmp_path, feats)
    emb = _write_vectors(tmp_path / "emb.tsv", CFG.kg_vocab_size, 32)
    kw = dict(kg_embedding_path=emb, batch_size=4, save_steps=2, log_steps=1,
              output_dir=str(tmp_path / "run"), compute_dtype="float32", device="cpu")
    state = tcli.run_pretraining(pkl, max_steps=3, **kw)
    assert state.step == 3
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == ["2", "3"]
    state2 = tcli.run_pretraining(pkl, max_steps=5, export_hf_dir=str(tmp_path / "hf"), **kw)
    assert state2.step == 5
    assert _jsonl_steps(tmp_path / "run") == [1, 2, 3, 4, 5]
    assert os.path.exists(tmp_path / "hf" / "pytorch_model.bin")
    store = _write_dataset("memmap", tmp_path, feats)
    kw["output_dir"] = str(tmp_path / "run_store")
    from_store = tcli.run_pretraining(store, max_steps=3, **kw)
    a, b = tree_flatten_with_path(state.params), tree_flatten_with_path(from_store.params)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_pretraining_prot(tmp_path):
    """``variant="prot"`` at a smoke width (32-wide KG vectors): two steps,
    one final save, the three backbones in bf16."""
    feats = _prot_features(4, 48, 16, 64, seed=3)
    rng = np.random.default_rng(3)
    for key, a, b in (("masked_lm_labels", 0, 48), ("ent_masked_lm_labels", 48, 64),
                      ("prot_masked_lm_labels", 64, 128)):
        pos = rng.integers(a, b, (4, 3))
        for i in range(4):
            feats[key][i, pos[i] - a] = feats["input_ids"][i, pos[i]]
    state = tcli.run_pretraining(
        _write_dataset("memmap", tmp_path, feats), variant="prot", device="cpu",
        kg_embedding_path=_write_vectors(tmp_path / "emb.tsv", 120, 32), batch_size=2,
        max_steps=2, save_steps=10, log_steps=1, output_dir=str(tmp_path / "run"))
    assert state.step == 2
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == ["2"]
    assert _jsonl_steps(tmp_path / "run") == [1, 2]
    for key in ("lm_backbone", "prot_backbone", "kg_backbone"):
        assert {t.dtype for t in tree_leaves(state.params[key])} == {torch.bfloat16}


def test_run_pretraining_reads_the_lm_checkpoint(tmp_path):
    """``lm_checkpoint``: a BioBERT-style state dict (``bert.`` keys) is
    the frozen LM backbone, leaf for leaf."""
    from stonkgs_tpu_torch.models import bert as tbert
    from stonkgs_tpu_torch.utils.hf_export import bert_state_dict

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(f"w{i}" for i in range(128)) + "\n")
    feats = features(CFG, 4, seed=9)
    emb = _write_vectors(tmp_path / "emb.tsv", CFG.kg_vocab_size, 32)
    cfg = tcli.stonkgs_pretraining_config(feats, "stonkgs", 32, 128)
    lm = tbert.init_bert_params(torch.Generator().manual_seed(7), cfg.bert, with_pooler=True)
    torch.save(bert_state_dict(lm, "bert."), tmp_path / "lm.bin")
    state = tcli.run_pretraining(
        _write_dataset("pickle", tmp_path, feats), kg_embedding_path=emb,
        vocab_file=str(vocab), lm_checkpoint=str(tmp_path / "lm.bin"), device="cpu",
        batch_size=4, max_steps=1, compute_dtype="float32", output_dir=str(tmp_path / "run"))
    got, want = tree_flatten_with_path(state.params["lm_backbone"]), tree_flatten_with_path(lm)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_run_pretraining_frozen_bf16(tmp_path):
    feats = features(CFG, 8, seed=7)
    state = tcli.run_pretraining(
        _write_dataset("pickle", tmp_path, feats), device="cpu", batch_size=4, max_steps=1,
        kg_embedding_path=_write_vectors(tmp_path / "emb.tsv", CFG.kg_vocab_size, 32),
        output_dir=str(tmp_path / "run"))
    for key in ("lm_backbone", "kg_backbone"):
        assert {t.dtype for t in tree_leaves(state.params[key])} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(state.params["trunk"])} == {torch.float32}


# ---------------------------------------------------------------------------
# dynamic masking
# ---------------------------------------------------------------------------

def test_mask_tokens_torch_statistics():
    B, L, vocab = 400, 256, 1000
    tokens = torch.randint(200, vocab, (B, L), generator=torch.Generator().manual_seed(0))
    masked, labels = mask_tokens_torch(torch.Generator().manual_seed(1), tokens, vocab)
    chosen = labels != IGNORE_INDEX
    assert (chosen.sum(1) == int(L * 0.15)).all()
    assert torch.equal(labels[chosen], tokens[chosen])
    assert torch.equal(masked[~chosen], tokens[~chosen])
    n = int(chosen.sum())
    is_mask = masked[chosen] == 103
    kept = masked[chosen] == tokens[chosen]
    for share, p in ((is_mask.float().mean(), 0.8), (kept.float().mean(), 0.1 + 0.1 / vocab)):
        assert abs(float(share) - p) < 4 * np.sqrt(p * (1 - p) / n)
    other = masked[chosen][~is_mask & ~kept]
    assert ((other >= 0) & (other < vocab)).all()
    m2, _ = mask_tokens_torch(torch.Generator().manual_seed(2), tokens, vocab)
    assert not torch.equal(m2, masked)
    assert mask_tokens_torch(torch.Generator(), tokens[:, :5], vocab)[1].eq(-100).all()


def test_dynamic_nsp_swap_properties():
    B, tl = 400, 16
    ids = torch.arange(B * 2 * tl).reshape(B, 2 * tl)
    labels = torch.full((B, tl), -100)
    out, lab, nsp = dynamic_nsp_swap(torch.Generator().manual_seed(0), ids, labels, tl)
    assert abs(float(nsp.float().mean()) - 0.2) < 4 * np.sqrt(0.2 * 0.8 / B)
    assert torch.equal(out[:, :tl], ids[:, :tl])
    pos = nsp == 0
    assert torch.equal(out[pos, tl:], ids[pos, tl:])
    assert torch.equal(lab, labels)


def test_dynamic_masking_loss_trains_and_replays():
    params = params_from_jax(_jax_params(), TCFG)
    feats = features(CFG, 8, seed=8)
    raw = {k: v for k, v in feats.items() if k in ("input_ids", "attention_mask",
                                                   "token_type_ids")}
    batch = tpre.to_device(raw, "cpu")
    loss_fn = dynamic_masking_loss()
    seen = []

    def base(p, cfg, b, **kw):
        seen.append(b)
        return tstonkgs.pretraining_loss(p, cfg, b, **kw)

    wrapped = dynamic_masking_loss(base_loss=base)
    with torch.no_grad():
        l3a, m = wrapped(params, TCFG, batch, deterministic=False,
                         rng=tpre.step_rng(0, 3, "cpu"))
        l3b, _ = loss_fn(params, TCFG, batch, deterministic=False,
                         rng=tpre.step_rng(0, 3, "cpu"))
        l4, _ = loss_fn(params, TCFG, batch, deterministic=False,
                        rng=tpre.step_rng(0, 4, "cpu"))
    assert float(l3a) == float(l3b) != float(l4)
    assert np.isfinite(float(l4)) and float(m["nsp_loss"]) > 0
    b = seen[0]
    assert ((b["masked_lm_labels"] != -100).sum(1) == int(CFG.text_len * 0.15)).all()
    assert ((b["ent_masked_lm_labels"] != -100).sum(1) == int(CFG.entity_len * 0.15)).all()
    with pytest.raises(ValueError, match="rng"):
        loss_fn(params, TCFG, batch)
    tx = AdamW(learning_rate=1e-3, total_steps=3)
    state = tpre.init_train_state(params, tx)
    step = tpre.make_train_step(TCFG, tx, loss_fn=loss_fn, compute_dtype=torch.float32)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and len(set(losses)) == 3
