"""The port's fine-tuning against the JAX package at fp32, on the CPU.

Weights come from the JAX ``init_*`` functions and reach the port through
``params_from_jax``; rows are made with a numpy seed.  Covered:

* the training half of ``classification_logits`` and
  ``classification_loss`` for STonKGs, the TransE layout (text 8 + 4) and
  ProtSTonKGs, at the tiny configurations of ``tests/test_finetuning.py``
  and ``tests/test_variant_finetuning.py``, with both dropouts at 0 (the
  JAX package's hidden dropout draws on ``jax.random``): logits within
  1e-5, gradients of every trainable leaf within 1e-4 of max |grad|, four
  ``make_train_step`` losses within 1e-4 relative; the classifier's
  dropout by its statistics;
* ``AdamW(max_grad_norm=None | 0.5 | 1.0)`` against ``make_optimizer``;
* the harness: splits and weighted F1 against scikit-learn (index for
  index, within 1e-12) and the JAX functions, ``encode_labels``,
  ``batched_apply``, ``RunLogger``, the CV on the toy task against the JAX
  harness from the same heads (equal F1, byte-equal TSV), the variants
  learning, and the CLI on files written in ``tmp_path``.
"""

import dataclasses
import importlib
import json

import numpy as np
import optax
import pytest
import torch
from sklearn.metrics import f1_score
from sklearn.model_selection import KFold, StratifiedShuffleSplit
from sklearn.utils.extmath import _approximate_mode as sk_approximate_mode

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.data import artifacts as jart
from stonkgs_tpu.models import heads as jheads
from stonkgs_tpu.models import protstonkgs as jprot
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.train import finetuning as jft
from stonkgs_tpu.train import pretraining as jpre
from stonkgs_tpu.train.optimizer import make_optimizer
from stonkgs_tpu.utils import batching as jbatching
from stonkgs_tpu.utils import hf_export as jexport
from stonkgs_tpu.utils.logging import RunLogger as JaxRunLogger
from stonkgs_tpu_torch.cli import finetune as tcli
from stonkgs_tpu_torch.models import protstonkgs as tprot
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.train import finetuning as tft
from stonkgs_tpu_torch.train import optimizer as topt
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils import hf_loader as tloader
from stonkgs_tpu_torch.utils.batching import batched_apply
from stonkgs_tpu_torch.utils.convert import params_from_jax, protstonkgs_params_from_jax
from stonkgs_tpu_torch.utils.logging import RunLogger
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

from test_torch_data import bel_names
from test_torch_hf_io import WORDS, bert_vocab
from test_torch_models import port_cfg
from test_torch_protstonkgs import port_cfg as prot_port_cfg

# stonkgs_tpu.cli binds the name ``finetune`` to its click command
jcli = importlib.import_module("stonkgs_tpu.cli.finetune")

TINY = jconfig.BertConfig(
    vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, max_position_embeddings=16, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0)
CFG = jconfig.STonKGsConfig(bert=TINY, kg_vocab_size=120, text_len=8, entity_len=8)
TRANSE_CFG = jconfig.STonKGsConfig(
    bert=dataclasses.replace(TINY, num_hidden_layers=1, max_position_embeddings=12),
    kg_vocab_size=120, text_len=8, entity_len=4)
PROT_TRUNK = jconfig.BigBirdConfig(
    vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
    intermediate_size=64, max_position_embeddings=64, block_size=4, num_random_blocks=1,
    attention_type="block_sparse", hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0)
PROT_CFG = jconfig.ProtSTonKGsConfig(
    trunk=PROT_TRUNK,
    lm=jconfig.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=64,
                          max_position_embeddings=8, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0),
    prot=jconfig.BertConfig(vocab_size=30, hidden_size=16, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=32,
                            max_position_embeddings=16, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0),
    lm_vocab_size=64, kg_vocab_size=40, prot_vocab_size=30, kg_start_idx=12,
    prot_start_idx=16, seq_len=32, sep_id=4, mask_id=5, unk_id=2, num_labels=2)
FROZEN = ("lm_backbone", "kg_backbone", "prot_backbone")
FAMILIES = ("stonkgs", "transe", "prot")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: its many small eager steps gain
    nothing from intra-op threads, which contend with the other test
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _named(tree, prefix=""):
    """{"a/b/0/c": leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, sub in items:
        out.update(_named(sub, f"{prefix}/{k}" if prefix else str(k)))
    return out


def toy_rows(family, n, seed=0, padded=False):
    """(features, int labels) of the separable tasks of
    ``tests/test_finetuning.py`` and ``tests/test_variant_finetuning.py``
    (the class is set by one text token); ``padded`` cuts the text to
    random lengths."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    if family == "prot":
        text = rng.integers(6, 64, (n, 12))
        text[:, 0] = np.where(y == 1, 6, 7)
        ids = np.concatenate([text, rng.integers(0, 40, (n, 4)),
                              rng.integers(5, 30, (n, 16))], 1)
        return {"input_ids": ids, "attention_mask": np.ones((n, 32), np.int64)}, y
    if family == "stonkgs":
        tl, el = 8, 8
        text = rng.integers(10, 64, (n, tl))
        text[:, 0] = np.where(y == 0, 5, 6)
    else:
        tl, el = 8, 4
        text = rng.integers(6, 64, (n, tl))
        text[:, 1] = np.where(y == 1, 4, 5)
    ent = rng.integers(0, 120, (n, el))
    keep = np.ones((n, tl), bool)
    if padded:
        keep = np.arange(tl)[None, :] < rng.integers(2, tl + 1, n)[:, None]
        text = np.where(keep, text, 0)
    return {
        "input_ids": np.concatenate([text, ent], 1),
        "attention_mask": np.concatenate([keep, np.ones((n, el), bool)], 1).astype(np.int64),
        "token_type_ids": np.concatenate([np.zeros((n, tl), np.int64),
                                          np.ones((n, el), np.int64)], 1),
    }, y


def _labels_str(y):
    return np.array(["pos" if v else "neg" for v in y], object)


class Family:
    """One model family on both sides: configs, modules, JAX parameters."""

    def __init__(self, name):
        self.name = name
        if name == "prot":
            self.jcfg, self.jmod, self.tmod = PROT_CFG, jprot, tprot
            self.tcfg = prot_port_cfg(PROT_CFG)
            self.convert = protstonkgs_params_from_jax
            p = jprot.init_protstonkgs_params(jax.random.PRNGKey(0), PROT_CFG,
                                              with_classifier=True)
        else:
            base = CFG if name == "stonkgs" else TRANSE_CFG
            self.jcfg, self.jmod, self.tmod = base.replace(num_labels=2), jstonkgs, tstonkgs
            self.tcfg = port_cfg(self.jcfg)
            self.convert = params_from_jax
            p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(0), self.jcfg,
                                             with_classifier=True)
        p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(1),
                                             (self.jcfg.kg_table_size, 32))
        self.params = jax.tree.map(np.asarray, p)

    def port_params(self):
        return self.convert(self.params, self.tcfg)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return Family(request.param)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def test_classification_logits_and_grads_match_jax(family):
    """Training mode at dropout 0: logits within 1e-5, the loss within
    1e-5 relative, and the gradient of every trainable leaf (trunk,
    heads, classifier; ProtSTonKGs' projection) within 1e-4 of max
    |grad|, the leaves no loss reaches at 0 on both sides."""
    feats, y = toy_rows(family.name, 5, seed=1, padded=True)
    batch = {**feats, "labels": y}
    jp = jax.tree.map(jnp.asarray, family.params)
    frozen = {k: v for k, v in jp.items() if k in FROZEN}
    train = {k: v for k, v in jp.items() if k not in FROZEN}
    jkw = dict(deterministic=False, dropout_rng=jax.random.PRNGKey(0))

    @jax.jit
    def jrun(train):
        logits = family.jmod.classification_logits({**train, **frozen}, family.jcfg,
                                                   _jb(feats), **jkw)
        return logits, jax.value_and_grad(
            lambda t: family.jmod.classification_loss({**t, **frozen}, family.jcfg,
                                                      _jb(batch), **jkw), has_aux=True)(train)

    jlogits, ((jloss, jm), jgrads) = jrun(train)

    tp = family.port_params()
    tb = tpre.to_device(batch, "cpu")
    tkw = dict(deterministic=False, rng=tpre.step_rng(0, 0, "cpu"))
    tlogits = family.tmod.classification_logits(tp, family.tcfg, tb, **tkw)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    named = _named(topt.split_frozen(tp)[0])
    for t in named.values():
        t.requires_grad_(True)
    tloss, tm = family.tmod.classification_loss(tp, family.tcfg, tb, **tkw)
    grads = torch.autograd.grad(tloss, list(named.values()), allow_unused=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert tm["accuracy"].item() == float(jm["accuracy"])

    jg = family.convert({**{k: v for k, v in family.params.items() if k in FROZEN},
                         **jax.tree.map(np.asarray, jgrads)}, family.tcfg)
    want = _named(topt.split_frozen(jg)[0])
    assert want.keys() == named.keys()
    assert {"classifier/kernel", "classifier/bias"} <= named.keys()
    scale = max(float(w.abs().max()) for w in want.values())
    for (name, w), g in zip(want.items(), grads):
        got = torch.zeros_like(w) if g is None else g
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


def test_train_steps_match_jax(family):
    """Four ``make_train_step(loss_fn=classification_loss)`` steps: the
    losses within 1e-4 relative of the JAX step's, accuracies equal."""
    feats, y = toy_rows(family.name, 16, seed=2, padded=True)
    batches = [{**{k: v[i::4] for k, v in feats.items()}, "labels": y[i::4]}
               for i in range(4)]
    tx = make_optimizer(None, learning_rate=1e-3, total_steps=4)
    jstate = jpre.init_train_state(jax.tree.map(jnp.asarray, family.params), tx)
    jstep = jpre.make_train_step(family.jcfg, tx, loss_fn=family.jmod.classification_loss,
                                 compute_dtype=jnp.float32, donate=False)
    ttx = topt.AdamW(learning_rate=1e-3, total_steps=4)
    tstate = tpre.init_train_state(family.port_params(), ttx)
    tstep = tpre.make_train_step(family.tcfg, ttx, loss_fn=family.tmod.classification_loss,
                                 compute_dtype=torch.float32)
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, _jb(b))
        tstate, tm = tstep(tstate, tpre.to_device(b, "cpu"))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
        assert tm["accuracy"].item() == float(jm["accuracy"])


@pytest.mark.parametrize("name", ["stonkgs", "prot"])
def test_classifier_dropout_statistics(name, monkeypatch):
    """The classifier's dropout, alone (the trunk replaced by a pooled
    output of ones, the head by the identity): every logit is 0 or
    1/(1-p) at the hidden dropout rate p, the kept share is within 5
    sigma of 1-p, two step generators draw other masks, and evaluation
    keeps every value."""
    p, B, H = 0.25, 64, 32
    if name == "prot":
        mod, cfg = tprot, prot_port_cfg(PROT_CFG)
        cfg = cfg.replace(trunk=dataclasses.replace(cfg.trunk, hidden_dropout_prob=p))
    else:
        mod, cfg = tstonkgs, port_cfg(CFG)
        cfg = cfg.replace(bert=dataclasses.replace(cfg.bert, hidden_dropout_prob=p))
    monkeypatch.setattr(mod, "trunk_forward", lambda *a, **k: (None, torch.ones(B, H)))
    params = {"classifier": {"kernel": torch.eye(H), "bias": torch.zeros(H)}}
    batch = {"input_ids": torch.zeros(B, 4, dtype=torch.int64)}
    masks = [mod.classification_logits(params, cfg, batch, deterministic=False,
                                       rng=tpre.step_rng(0, s, "cpu")) for s in (0, 1)]
    for m in masks:
        kept = m != 0
        torch.testing.assert_close(m[kept], torch.full_like(m[kept], 1.0 / (1.0 - p)))
        share = kept.float().mean().item()
        assert abs(share - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / (B * H)), share
    assert not torch.equal(masks[0], masks[1])
    assert torch.equal(mod.classification_logits(params, cfg, batch, deterministic=True),
                       torch.ones(B, H))


@pytest.mark.parametrize("max_grad_norm", [None, 0.5, 1.0])
def test_adamw_clip_matches_jax(max_grad_norm):
    """Three AdamW updates (weight decay 0.01, gradients of norm 10, 0.3
    and 2) against the optax chain of ``make_optimizer`` within 1e-6; a
    clip changes the result, and the default (pre-training's) is 1.0."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8, 5)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    steps = []
    for norm in (10.0, 0.3, 2.0):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        total = np.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
        steps.append({k: v * np.float32(norm / total) for k, v in g.items()})
    kw = dict(learning_rate=1e-2, total_steps=10, weight_decay=0.01,
              max_grad_norm=max_grad_norm)
    tx = make_optimizer(None, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in steps:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    def port(clip):
        ttx = topt.AdamW(**{**kw, "max_grad_norm": clip})
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        st = ttx.init(tp)
        for g in steps:
            ttx.update_and_apply([torch.from_numpy(g[k]) for k in tp], st, tree_leaves(tp))
        return tp

    got = port(max_grad_norm)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
    if max_grad_norm is not None:
        assert not torch.allclose(got["w"], port(None)["w"], atol=1e-5, rtol=0)
    assert topt.AdamW().max_grad_norm == 1.0


# ---------------------------------------------------------------------------
# splits, metric, labels, helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 40, 101])
@pytest.mark.parametrize("n_splits", [5, 2, 1])
def test_splits_match_sklearn_and_jax(n, n_splits):
    labels = np.random.default_rng(n).integers(0, 3, n)
    got = tft.get_train_test_splits(labels, n_splits=n_splits)
    want = jft.get_train_test_splits(labels, n_splits=n_splits)
    kfold = KFold(n_splits=5 if n_splits == 1 else n_splits, shuffle=True, random_state=42)
    sk = list(kfold.split(np.zeros((n, 1))))[: 1 if n_splits == 1 else None]
    assert len(got) == len(want) == len(sk)
    for g, w, (tr, te) in zip(got, want, sk):
        for key, ref in (("train_idx", tr), ("test_idx", te)):
            np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(g[key], ref)
            assert g[key].dtype == w[key].dtype


# class counts of the labels, the cap, n_splits: unbalanced classes; ties
# of _approximate_mode's remainders (rng.choice breaks them), with 5 and
# 2 folds after the cap; two classes of odd and even size
CAP_CASES = {
    "unbalanced": ([60, 25, 12, 3], 50, 2),
    "ties": ([3, 3, 3, 3], 6, 2),
    "ties-first-fold": ([5, 5, 5], 10, 1),
    "two-classes": ([51, 50], 98, 5),
    "many-ties": ([7] * 9, 40, 5),
}


@pytest.mark.parametrize("case", CAP_CASES)
def test_split_size_cap_matches_sklearn_and_jax(case):
    counts, cap, n_splits = CAP_CASES[case]
    labels = np.random.default_rng(3).permutation(np.repeat(np.arange(len(counts)), counts))
    got = tft.get_train_test_splits(labels, n_splits=n_splits, max_dataset_size=cap)
    want = jft.get_train_test_splits(labels, n_splits=n_splits, max_dataset_size=cap)
    keep, _ = next(StratifiedShuffleSplit(n_splits=1, train_size=cap, random_state=42)
                   .split(np.zeros((len(labels), 1)), labels))
    kfold = KFold(n_splits=5 if n_splits == 1 else n_splits, shuffle=True, random_state=42)
    sk = list(kfold.split(np.zeros((cap, 1))))[: 1 if n_splits == 1 else None]
    assert len(got) == len(want) == len(sk)
    for g, w, (tr, te) in zip(got, want, sk):
        for key, ref in (("train_idx", keep[tr]), ("test_idx", keep[te])):
            np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(g[key], ref)
    used = np.concatenate([got[0]["train_idx"], got[0]["test_idx"]])
    assert len(np.unique(used)) == cap


def test_approximate_mode_matches_sklearn():
    """Draw counts and the generator's state afterwards, over random
    class counts (many with tied remainders)."""
    gen = np.random.default_rng(4)
    for trial in range(200):
        counts = gen.integers(1, 6 if trial % 2 else 40, gen.integers(1, 8))
        draws = int(gen.integers(0, counts.sum() + 1))
        a, b = np.random.RandomState(trial), np.random.RandomState(trial)
        np.testing.assert_array_equal(tft._approximate_mode(counts, draws, a),
                                      sk_approximate_mode(counts, draws, b))
        assert a.randint(1 << 30) == b.randint(1 << 30)


F1_CASES = {
    "random": (np.random.default_rng(5).integers(0, 4, 50),
               np.random.default_rng(6).integers(0, 4, 50)),
    "only-in-y_true": (np.array([0, 0, 1, 1, 2, 2, 3]), np.array([0, 0, 1, 0, 1, 1, 0])),
    "only-in-y_pred": (np.array([0, 0, 1, 1, 1]), np.array([0, 2, 1, 3, 1])),
    "perfect": (np.array([2, 0, 1, 2]), np.array([2, 0, 1, 2])),
    "all-wrong": (np.array([0, 0, 1]), np.array([1, 1, 0])),
    "one-class": (np.array([1, 1, 1]), np.array([1, 1, 1])),
}


@pytest.mark.parametrize("case", F1_CASES)
def test_weighted_f1_matches_sklearn(case):
    y_true, y_pred = F1_CASES[case]
    got = tft.weighted_f1(y_true, y_pred)
    assert isinstance(got, float)
    assert abs(got - f1_score(y_true, y_pred, average="weighted")) <= 1e-12
    assert abs(got - jft.weighted_f1(y_true, y_pred)) <= 1e-12


def test_encode_labels_matches_jax():
    """Classes numbered in ``set()`` order on both sides (one process,
    one hash seed)."""
    labels = ["b", "a", "c", "a", "d", "b", "e"]
    got, want = tft.encode_labels(labels), jft.encode_labels(labels)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1:] == want[1:]


def test_batched_apply_pads_the_tail_and_handles_empty():
    feats = {"input_ids": np.arange(10).reshape(5, 2), "labels": np.zeros(5)}
    seen = []

    def fn(batch):
        seen.append(batch["input_ids"].clone())
        return torch.stack([batch["input_ids"].sum(1), -batch["input_ids"][:, 0]], 1)

    out = batched_apply(fn, feats, ("input_ids", "attention_mask"), 2)
    want = jbatching.batched_apply(
        lambda b: jnp.stack([b["input_ids"].sum(1), -b["input_ids"][:, 0]], 1),
        feats, ("input_ids", "attention_mask"), 2)
    np.testing.assert_array_equal(out, want)
    assert out.dtype == np.float32 and out.shape == (5, 2)
    assert [tuple(s.shape) for s in seen] == [(2, 2)] * 3
    torch.testing.assert_close(seen[-1], torch.tensor([[8, 9], [8, 9]]))  # last row repeated
    empty = batched_apply(fn, {"input_ids": np.zeros((0, 2), np.int64)}, ("input_ids",), 4)
    assert empty.shape == (0, 2) and empty.dtype == np.float32


def test_run_logger_writes_the_jax_records(tmp_path, capsys):
    records = {}
    for name, cls in (("jax", JaxRunLogger), ("port", RunLogger)):
        with cls(log_dir=str(tmp_path / name), experiment="exp", run_name="run") as log:
            log.log_param("label dict", {"a": 0, "b": 1})
            log.log_param("size", 12)
            log.log_metric("f1", np.float32(0.5), step=1)
            log.log_metrics({"mean": 0.75, "std": 0.25})
        lines = (tmp_path / name / "exp-run.jsonl").read_text().splitlines()
        out = capsys.readouterr().out.splitlines()
        records[name] = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                         for line in lines]
        assert [json.loads(line)["key"] for line in out] == [r["key"] for r in records[name]]
    assert records["port"] == records["jax"] and len(records["port"]) == 5


# ---------------------------------------------------------------------------
# the harness and the CLI
# ---------------------------------------------------------------------------

def _jax_heads(monkeypatch):
    """The port's head init returns the JAX head of ``PRNGKey(seed)``."""
    def init(gen, cfg, num_labels):
        head = jheads.init_classifier_head(jax.random.PRNGKey(gen.initial_seed()), cfg,
                                           num_labels)
        return {k: torch.from_numpy(np.array(v)) for k, v in head.items()}
    monkeypatch.setattr(tft, "init_classifier_head", init)


def test_cv_matches_jax_on_the_toy_task(tmp_path, monkeypatch):
    """The toy task of ``tests/test_finetuning.py`` from the same heads:
    equal F1 (above 0.9), a byte-equal TSV, exported models that agree,
    and the pretrained tree passed in unchanged."""
    fam = Family("stonkgs")
    feats, y = toy_rows("stonkgs", 64)
    labels = _labels_str(y)
    params = {**fam.params}
    params.pop("classifier")
    run = dict(epochs=16, lr=3e-3, batch_size=16, cv=2, compute_dtype="float32",
               eval_batch_size=16)
    want = jft.run_sequence_classification_cv(
        feats, labels, jax.tree.map(jnp.asarray, params), CFG, jft.FinetuneConfig(**run),
        task_name="toy", output_dir=str(tmp_path / "jax"))
    _jax_heads(monkeypatch)
    tp = params_from_jax(params, port_cfg(CFG))
    before = tree_map(torch.clone, tp)
    got = tft.run_sequence_classification_cv(
        feats, labels, tp, port_cfg(CFG), tft.FinetuneConfig(**run),
        task_name="toy", output_dir=str(tmp_path / "port"))
    for k in ("f1_score_mean", "f1_score_std"):
        assert abs(got[k] - want[k]) <= 1e-12, (got, want)
    assert got["f1_score_mean"] > 0.9, got
    tsv = "predicted_labels_stonkgs_toydf.tsv"
    assert (tmp_path / "port" / tsv).read_bytes() == (tmp_path / "jax" / tsv).read_bytes()
    for a, b in zip(tree_leaves(tp), tree_leaves(before)):
        assert torch.equal(a, b)
    sd_port = tloader.load_state_dict(str(tmp_path / "port" / "toy"))
    sd_jax = tloader.load_state_dict(str(tmp_path / "jax" / "toy"))
    assert sd_port.keys() == sd_jax.keys() and "classifier.weight" in sd_port
    for k in sd_port:
        torch.testing.assert_close(sd_port[k], sd_jax[k], atol=1e-3, rtol=0, msg=k)
    assert (json.loads((tmp_path / "port/toy/config.json").read_text())
            == json.loads((tmp_path / "jax/toy/config.json").read_text()))


@pytest.mark.parametrize("name, floor", [("transe", 0.9), ("prot", 0.85)])
def test_variants_learn(name, floor):
    """The variants of ``tests/test_variant_finetuning.py`` through the
    port's harness: the TransE layout (8 + 4) and ProtSTonKGs."""
    fam = Family(name)
    n = 32 if name == "prot" else 48
    feats, y = toy_rows(name, n)
    params = {k: v for k, v in fam.port_params().items() if k != "classifier"}
    kw = {}
    if name == "prot":
        kw = dict(loss_fn=tprot.classification_loss, logits_fn=tprot.classification_logits,
                  trunk_cfg=fam.tcfg.trunk)
    result = tft.run_sequence_classification_cv(
        feats, _labels_str(y), params, fam.tcfg,
        tft.FinetuneConfig(epochs=40, lr=3e-3, batch_size=8, cv=2, compute_dtype="float32",
                           eval_batch_size=16), **kw)
    assert result["f1_score_mean"] > floor, result


def test_finetuning_cli_matches_jax(tmp_path, monkeypatch):
    """``cli/finetune.run_finetuning`` on a checkpoint, node2vec TSVs, a
    vocabulary and a task TSV written here (rows whose source is not in
    the KG are dropped), against the JAX CLI from the same heads: equal
    F1, byte-equal TSVs and the same run-log records."""
    bert = jconfig.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                              num_attention_heads=2, intermediate_size=64,
                              max_position_embeddings=32, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    cfg = jconfig.STonKGsConfig(bert=bert, kg_vocab_size=101, text_len=16, entity_len=16)
    params = jax.tree.map(np.asarray, jstonkgs.init_stonkgs_params(jax.random.PRNGKey(0), cfg))
    jexport.save_pretrained(params, cfg, str(tmp_path / "ckpt"))
    art = jart.make_random_artifacts(101, dim=32, rw_len=7, seed=1)
    art.names = bel_names(101)
    art.name_to_idx = {n: i for i, n in enumerate(art.names)}
    jart.save_kg_artifacts(art, tmp_path / "emb.tsv", tmp_path / "walks.tsv")
    (tmp_path / "vocab.txt").write_text("\n".join(bert_vocab(128)) + "\n")
    rng = np.random.default_rng(7)
    lines = ["source\ttarget\tevidence\tclass\tpmid"]
    for i in range(44):
        label = ["up", "down"][i % 2]
        verb = "activates" if label == "up" else "inhibits"
        words = " ".join(rng.choice(WORDS[:4], 5))
        src = art.names[rng.integers(101)] if i % 11 else "p(HGNC:0 ! NOT_IN_KG)"
        lines.append(f"{src}\t{art.names[rng.integers(101)]}\t{words} {verb} {words}\t"
                     f"{label}\t{i}")
    (tmp_path / "task.tsv").write_text("\n".join(lines) + "\n")
    args = [str(tmp_path / p) for p in ("task.tsv", "ckpt", "emb.tsv", "walks.tsv",
                                        "vocab.txt")]
    kw = dict(epochs=3, cv=2, lr=3e-3, batch_size=8, task_name="toy", compute_dtype="float32")
    want = jcli.run_finetuning(*args, output_dir=str(tmp_path / "jax"), **kw)
    _jax_heads(monkeypatch)
    got = tcli.run_finetuning(*args, output_dir=str(tmp_path / "port"), device="cpu", **kw)
    for k in ("f1_score_mean", "f1_score_std"):
        assert abs(got[k] - want[k]) <= 1e-12, (got, want)
    tsv = "predicted_labels_stonkgs_toydf.tsv"
    assert (tmp_path / "port" / tsv).read_bytes() == (tmp_path / "jax" / tsv).read_bytes()
    assert len((tmp_path / "port" / tsv).read_text().splitlines()) == 1 + 40

    def records(d):
        (log,) = d.glob("*.jsonl")
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in log.read_text().splitlines()]
    assert records(tmp_path / "port") == records(tmp_path / "jax")
