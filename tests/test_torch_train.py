"""The port's pre-training path against the JAX package at fp32, on the CPU.

Weights come from the JAX ``init_*`` functions and reach the port through
``params_from_jax``; batches are made with a numpy seed, with exactly
int(0.15 * len) masked positions per half as the data pipeline makes them.
The model runs in training mode (``deterministic=False``) with both
dropout probabilities at 0: the JAX package's hidden-state dropout draws
on ``jax.random`` and cannot be matched (the attention hash dropout is
matched bit for bit in ``test_torch_train_ops.py``).

Tolerances: the loss to rtol 1e-5; gradients atol 1e-5 / rtol 1e-3, as
both frameworks sum in another order through every layer; updated
parameters atol 1e-5, 1% of one AdamW step (a first step moves a
parameter by lr·g/(|g| + eps), about lr = 1e-3, and the normalisation
turns the gradients' last-digit differences into differences of the
step for elements with a small gradient).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.train import pretraining as jpre
from stonkgs_tpu.train.optimizer import make_optimizer
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.models import bert as tbert
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.train import optimizer as topt
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import bert_params_from_jax, params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

GRAD_TOL = dict(atol=1e-5, rtol=1e-3)

BERT = jconfig.BertConfig(
    vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=32, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0)
CFG = jconfig.STonKGsConfig(bert=BERT, kg_vocab_size=101, text_len=16, entity_len=16)


def port_cfg(cfg):
    """The port's config with the same fields as a JAX-package config."""
    d = dataclasses.asdict(cfg)
    return tconfig.STonKGsConfig(**{**d, "bert": tconfig.BertConfig(**d["bert"])})


TCFG = port_cfg(CFG)


def features(cfg, n, seed=0):
    """Pre-training rows: text halves of random true length (masked keys
    in the trunk), int(0.15 * len) masked positions per half."""
    rng = np.random.default_rng(seed)
    tl, el = cfg.text_len, cfg.entity_len
    lengths = rng.integers(4, tl + 1, n)
    keep = np.arange(tl)[None, :] < lengths[:, None]
    text = np.where(keep, rng.integers(4, cfg.bert.vocab_size, (n, tl)), 0)
    mlm = np.full((n, tl), -100, np.int64)
    elm = np.full((n, el), -100, np.int64)
    for i in range(n):
        mlm[i, rng.choice(tl, int(tl * 0.15), replace=False)] = rng.integers(
            0, cfg.bert.vocab_size, int(tl * 0.15))
        elm[i, rng.choice(el, int(el * 0.15), replace=False)] = rng.integers(
            0, cfg.kg_vocab_size, int(el * 0.15))
    return {
        "input_ids": np.concatenate(
            [text, rng.integers(0, cfg.kg_vocab_size, (n, el))], 1).astype(np.int32),
        "attention_mask": np.concatenate(
            [keep.astype(np.int32), np.ones((n, el), np.int32)], 1),
        "token_type_ids": np.concatenate(
            [np.zeros((n, tl), np.int32), np.ones((n, el), np.int32)], 1),
        "masked_lm_labels": mlm,
        "ent_masked_lm_labels": elm,
        "next_sentence_labels": rng.integers(0, 2, n).astype(np.int64),
    }


@pytest.fixture(scope="module")
def params():
    """JAX-initialised STonKGs params with a random KG table, as numpy."""
    p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(0), CFG)
    p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(1),
                                         (CFG.kg_table_size, BERT.hidden_size))
    return jax.tree.map(np.asarray, p)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return tpre.to_device(batch, "cpu")


def _port_trainable(tree):
    """A JAX trainable tree (numpy leaves) in the port's layout."""
    return {"trunk": bert_params_from_jax(tree["trunk"], TCFG.bert),
            "cls": tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree["cls"])}


def _assert_trees_close(got: dict, want: dict, **tol):
    for k in want:
        for i, (g, w) in enumerate(zip(tree_leaves(got[k]), tree_leaves(want[k]))):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                       err_msg=f"{k} leaf {i}", **tol)


@pytest.mark.parametrize("dense_heads", [False, True], ids=["gathered", "dense"])
def test_pretraining_loss_and_grads_match_jax(params, dense_heads):
    batch = features(CFG, 3, seed=1)
    jp = jax.tree.map(jnp.asarray, params)
    frozen = {k: jp[k] for k in ("lm_backbone", "kg_backbone")}

    def jloss(train):
        return jstonkgs.pretraining_loss(
            {**train, **frozen}, CFG, _jb(batch), dense_heads=dense_heads,
            deterministic=False, dropout_rng=jax.random.PRNGKey(0))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        {"trunk": jp["trunk"], "cls": jp["cls"]})

    tp = params_from_jax(params, TCFG)
    train = {"trunk": tp["trunk"], "cls": tp["cls"]}
    leaves = tree_leaves(train)
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = tstonkgs.pretraining_loss(tp, TCFG, _tb(batch), dense_heads=dense_heads,
                                       deterministic=False,
                                       rng=tpre.step_rng(0, 0, "cpu"))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    for k in ("loss", "mlm_loss", "elm_loss", "nsp_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    got = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    want = tree_leaves(_port_trainable(jax.tree.map(np.asarray, jg)))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"grad leaf {i}", **GRAD_TOL)


def test_pretraining_logits_match_jax(params):
    batch = features(CFG, 2, seed=2)
    want = jstonkgs.pretraining_logits(jax.tree.map(jnp.asarray, params), CFG,
                                       **{k: jnp.asarray(batch[k]) for k in (
                                           "input_ids", "attention_mask", "token_type_ids")})
    tb = _tb(batch)
    got = tstonkgs.pretraining_logits(params_from_jax(params, TCFG), TCFG, tb["input_ids"],
                                      tb["attention_mask"], tb["token_type_ids"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(params, accum):
    """One step of make_train_step, updated trainable parameters and
    metrics, with gradient accumulation over 1 or 2 micro-batches."""
    batch = features(CFG, 4, seed=3)
    tx = make_optimizer(None, learning_rate=1e-3, total_steps=10)
    jstate = jpre.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jpre.make_train_step(CFG, tx, compute_dtype=jnp.float32,
                                 grad_accumulation_steps=accum, donate=False)
    jstate, jm = jstep(jstate, _jb(batch))

    tp = params_from_jax(params, TCFG)
    ttx = topt.AdamW(learning_rate=1e-3, total_steps=10)
    tstate = tpre.init_train_state(tp, ttx)
    tstep = tpre.make_train_step(TCFG, ttx, compute_dtype=torch.float32,
                                 grad_accumulation_steps=accum)
    tstate, tm = tstep(tstate, _tb(batch))
    assert tstate.step == 1 and tstate.opt_state["count"] == 1
    for k in ("loss", "mlm_loss", "elm_loss", "nsp_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    want = _port_trainable(jax.tree.map(np.asarray, jstate.params))
    _assert_trees_close(tstate.params, want, atol=1e-5, rtol=0)
    assert not any(t.requires_grad for t in tree_leaves(tstate.params))


def test_pretrain_runs_three_steps(params):
    """pretrain at tiny size on the CPU, with the dropouts on: finite
    losses, log_fn at every step, frozen parameters untouched, trainable
    ones moved, the caller's tensors unchanged."""
    cfg = port_cfg(CFG.replace(bert=dataclasses.replace(
        BERT, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)))
    tp = params_from_jax(params, cfg)
    before = tree_map(lambda t: t.clone(), tp)
    logged = []
    run = tpre.PretrainingConfig(max_steps=3, micro_batch_size=4, log_steps=1,
                                 compute_dtype="float32", seed=5)
    state = tpre.pretrain(cfg, tp, features(CFG, 12, seed=4), run,
                          log_fn=lambda step, m: logged.append((step, m)))
    assert [s for s, _ in logged] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for _, m in logged)
    assert "examples_per_sec" in logged[-1][1]
    assert state.step == 3
    for k in ("lm_backbone", "kg_backbone"):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params[k]),
                                                     tree_leaves(before[k])))
    for a, b in zip(tree_leaves(tp), tree_leaves(before)):
        assert torch.equal(a, b)   # the caller's tree
    moved = state.params["trunk"]["encoder"][0]["intermediate"]["kernel"]
    assert not torch.equal(moved, before["trunk"]["encoder"][0]["intermediate"]["kernel"])


def test_pretrain_unported_options_raise(params, tmp_path):
    """Remat raises; the mesh runs (a 1 x 1 mesh here, the sharded ones in
    ``test_torch_parallel.py``), a mesh of several ranks without process
    groups raises; a ``checkpoint_dir`` saves."""
    from stonkgs_tpu_torch.parallel.mesh import Mesh, make_mesh

    tp = params_from_jax(params, TCFG)
    feats = features(CFG, 4)
    run = tpre.PretrainingConfig(max_steps=1, micro_batch_size=4, compute_dtype="float32")
    meshed = tpre.pretrain(TCFG, tp, feats, run, mesh=make_mesh(1, 1))
    assert meshed.step == 1 and meshed.layout is not None
    with pytest.raises(ValueError, match="make_mesh"):
        tpre.pretrain(TCFG, tp, feats, run, mesh=Mesh(2, 1))
    state = tpre.pretrain(TCFG, tp, feats, run, checkpoint_dir=str(tmp_path / "ckpt"))
    assert state.step == 1
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1"]
    with pytest.raises(ValueError, match="remat"):
        tpre.make_train_step(TCFG, topt.AdamW(), remat="selective")
    assert tpre.resolve_train_impl() == (False, "flash")
    assert tpre.resolve_train_impl("auto", "flash") == (False, "flash")
    assert tpre.resolve_train_impl(mesh=make_mesh(1, 1)) == (False, "flash")


def test_step_replays_from_seed_and_step(params):
    """A step's dropout streams come from (seed, step): the same pair gives
    the same loss, another step another one."""
    cfg = port_cfg(CFG.replace(bert=dataclasses.replace(
        BERT, hidden_dropout_prob=0.2, attention_probs_dropout_prob=0.2)))
    tp = params_from_jax(params, cfg)
    batch = _tb(features(CFG, 2, seed=6))

    def loss(step):
        with torch.no_grad():
            return tstonkgs.pretraining_loss(tp, cfg, batch, deterministic=False,
                                             rng=tpre.step_rng(9, step, "cpu"))[0].item()
    assert loss(3) == loss(3)
    assert loss(3) != loss(4)


def test_hidden_dropout_statistics():
    rng = tpre.step_rng(0, 0, "cpu")
    x = torch.ones(200, 500)
    y = tbert.dropout(x, 0.1, rng, deterministic=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert tbert.dropout(x, 0.1, rng, deterministic=True) is x
    assert tbert.dropout(x, 0.1, None, deterministic=False) is x


@pytest.mark.parametrize("skip", [0, 2, 5])
def test_data_iterator_matches_jax(skip):
    rng = np.random.default_rng(10)
    feats = {"input_ids": rng.integers(0, 9, (10, 4)), "labels": rng.integers(0, 2, 10)}
    ours = tpre.data_iterator(feats, 3, seed=7, skip_steps=skip)
    ref = jpre.data_iterator(feats, 3, seed=7, skip_steps=skip)
    for _ in range(7):
        a, b = next(ours), next(ref)
        for k in feats:
            np.testing.assert_array_equal(a[k], b[k])
