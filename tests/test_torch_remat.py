"""Layer remat of the port (``remat`` none / full / attention / unroll) on the CPU.

* With dropout on (hidden and attention at 0.1), "full" and "attention"
  equal "none" for ``bert.encode``, ``make_train_step`` (and through it
  ``pretrain`` and ``train_classifier``) and ``bigbird_model``: losses,
  outputs and gradients within 1e-6, and bit for bit as the CPU gives
  them with one torch thread (with several, the CPU's accumulating
  ``index_put`` of the embeddings' backward adds in no fixed order).
* The recompute draws nothing of its own: after a forward and a backward
  both generators of the :class:`DropoutRng` are where a run without
  remat leaves them; a checkpoint that lets the recompute draw shows up
  there (and in the gradients).
* Each mode matches the JAX package's same mode under
  ``deterministic=True`` (its dropout draws on ``jax.random``): outputs
  within 1e-5, gradients within 1e-5 absolute + 1e-3 relative, as
  ``tests/test_torch_train.py`` holds the two.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import bert as jbert
from stonkgs_tpu.models import bigbird as jbigbird
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.models import bert as tbert
from stonkgs_tpu_torch.models import bigbird as tbigbird
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.train import finetuning as tft
from stonkgs_tpu_torch.train import optimizer as topt
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import (
    bert_params_from_jax,
    bigbird_params_from_jax,
    params_from_jax,
)
from stonkgs_tpu_torch.utils.tree import tree_leaves

SAME = dict(atol=1e-6, rtol=0)
FWD_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
MODES = ["full", "attention"]

BERT = jconfig.BertConfig(
    vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=32, hidden_dropout_prob=0.1,
    attention_probs_dropout_prob=0.1)
CFG = jconfig.STonKGsConfig(bert=BERT, kg_vocab_size=101, text_len=16, entity_len=16)
BB = jconfig.BigBirdConfig(
    vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, max_position_embeddings=64, block_size=4, num_random_blocks=1,
    hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
S_SPARSE = 32   # > (5 + 2r) * bs = 28: block-sparse


def port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return tconfig.STonKGsConfig(**{**d, "bert": tconfig.BertConfig(**d["bert"])})


TCFG = port_cfg(CFG)
TBB = tconfig.BigBirdConfig(**dataclasses.asdict(BB))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the CPU then adds every gradient in a fixed order,
    so two equal runs are equal bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(0), CFG)
    p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(1),
                                         (CFG.kg_table_size, BERT.hidden_size))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def bb_params():
    return jax.tree.map(np.asarray, jbigbird.init_bigbird_params(jax.random.PRNGKey(0), BB))


def features(cfg, n, seed=0):
    """Pre-training rows with padded text halves and int(0.15 * len)
    masked positions a half."""
    rng = np.random.default_rng(seed)
    tl, el = cfg.text_len, cfg.entity_len
    keep = np.arange(tl)[None, :] < rng.integers(4, tl + 1, n)[:, None]
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
            [text, rng.integers(0, cfg.kg_vocab_size, (n, el))], 1).astype(np.int64),
        "attention_mask": np.concatenate([keep, np.ones((n, el), bool)], 1).astype(np.int64),
        "token_type_ids": np.concatenate(
            [np.zeros((n, tl), np.int64), np.ones((n, el), np.int64)], 1),
        "masked_lm_labels": mlm,
        "ent_masked_lm_labels": elm,
        "next_sentence_labels": rng.integers(0, 2, n).astype(np.int64),
    }


def _assert_same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   err_msg=f"{what} {i}", **SAME)
        assert torch.equal(g, w), f"{what} {i} not bit-equal"


def _encoder_inputs(seed, S=16, H=64):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(3, S, H)).astype(np.float32))
    mask = np.ones((3, S), np.int64)
    mask[1, S // 2:] = 0
    w = torch.from_numpy(rng.normal(size=(3, S, H)).astype(np.float32))
    return x, torch.from_numpy(mask), w


def _encode_grads(tp, remat, rng, deterministic=False):
    """(output, d(sum(out * w)) / d(x, layer leaves)) of ``bert.encode``."""
    x, mask, w = _encoder_inputs(3)
    x.requires_grad_(True)
    leaves = tree_leaves(tp["encoder"])
    for t in leaves:
        t.requires_grad_(True)
    try:
        out = tbert.encode(tp, port_cfg(CFG).bert, x, mask, deterministic=deterministic,
                           rng=rng, remat=remat)
        grads = torch.autograd.grad((out * w).sum(), [x] + leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return out.detach(), grads


@pytest.mark.parametrize("mode", MODES)
def test_encode_remat_equals_none_with_dropout(params, mode):
    tp = bert_params_from_jax(params["trunk"], TCFG.bert)
    out0, g0 = _encode_grads(tp, "none", tpre.step_rng(5, 1, "cpu"))
    out1, g1 = _encode_grads(tp, mode, tpre.step_rng(5, 1, "cpu"))
    # dropout acted: another seed gives another output
    other, _ = _encode_grads(tp, "none", tpre.step_rng(6, 1, "cpu"))
    assert not torch.allclose(other, out0)
    _assert_same([out1], [out0], "output")
    _assert_same(g1, g0, "gradient")


def _naive_checkpointed(fn, x, rng):
    """A checkpoint that lets the recompute draw its own dropout masks."""
    return checkpoint(fn, x, use_reentrant=False)


@pytest.mark.parametrize("mode", MODES)
def test_recompute_leaves_the_generators_as_none_does(params, mode, monkeypatch):
    """After a forward and its backward both generators stand where a run
    without remat leaves them: the recompute drew no attention seed of
    its own (``host``) and no mask (``device``).  A checkpoint that lets
    the recompute draw is caught here and in the gradients."""
    tp = bert_params_from_jax(params["trunk"], TCFG.bert)
    r0, r1 = tpre.step_rng(5, 1, "cpu"), tpre.step_rng(5, 1, "cpu")
    _, g0 = _encode_grads(tp, "none", r0)
    _, g1 = _encode_grads(tp, mode, r1)
    assert torch.equal(r1.host.get_state(), r0.host.get_state())
    assert torch.equal(r1.device.get_state(), r0.device.get_state())
    _assert_same(g1, g0, "gradient")
    if mode == "full":   # the sub-block of "attention" draws no mask
        monkeypatch.setattr(tbert, "checkpointed", _naive_checkpointed)
        r2 = tpre.step_rng(5, 1, "cpu")
        _, g2 = _encode_grads(tp, mode, r2)
        assert not torch.equal(r2.device.get_state(), r0.device.get_state())
        assert any(not torch.allclose(a, b) for a, b in zip(g2, g0))


def _run_steps(params, remat, steps=2, n=4):
    tp = params_from_jax(params, TCFG)
    tx = topt.AdamW(learning_rate=1e-3)
    state = tpre.init_train_state(tp, tx, seed=3)
    step = tpre.make_train_step(TCFG, tx, compute_dtype=torch.float32, remat=remat)
    feats = features(CFG, n * steps, seed=2)
    losses = []
    for i in range(steps):
        batch = tpre.to_device({k: v[i * n:(i + 1) * n] for k, v in feats.items()}, "cpu")
        state, m = step(state, batch)
        losses.append(m["loss"])
    return losses, tree_leaves(state.params)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_remat_equals_none_with_dropout(params, mode):
    l0, p0 = _run_steps(params, "none")
    l1, p1 = _run_steps(params, mode)
    _assert_same(l1, l0, "loss")
    _assert_same(p1, p0, "parameter")


@pytest.mark.parametrize("mode", MODES)
def test_pretrain_and_train_classifier_take_remat(params, mode):
    """``PretrainingConfig.remat`` and ``FinetuneConfig.remat`` reach the
    step: the same states as without remat."""
    feats = features(CFG, 8, seed=4)
    states = {}
    for m in ("none", mode):
        run = tpre.PretrainingConfig(max_steps=2, micro_batch_size=4, compute_dtype="float32",
                                     remat=m)
        states[m] = tpre.pretrain(TCFG, params_from_jax(params, TCFG), feats, run)
    _assert_same(tree_leaves(states[mode].params), tree_leaves(states["none"].params),
                 "pretrain parameter")
    ft = {k: feats[k] for k in ("input_ids", "attention_mask", "token_type_ids")}
    ft["labels"] = np.arange(8) % 2
    cfg = TCFG.replace(num_labels=2)
    got = {}
    for m in ("none", mode):
        run = tft.FinetuneConfig(epochs=1, lr=1e-3, batch_size=4, compute_dtype="float32",
                                 remat=m)
        state, metrics = tft.train_classifier(cfg, params_from_jax(params, TCFG), ft, run)
        got[m] = (metrics, tree_leaves(state.params))
    assert got[mode][0] == got["none"][0]
    _assert_same(got[mode][1], got["none"][1], "classifier run parameter")


def _bigbird_grads(tp, remat, rng, attention_type, deterministic=False):
    rs = np.random.default_rng(1)
    x = torch.from_numpy(rs.normal(size=(3, S_SPARSE, BB.hidden_size)).astype(np.float32))
    mask = np.ones((3, S_SPARSE), np.int64)
    mask[1, 20:] = 0
    w = torch.from_numpy(rs.normal(size=(3, S_SPARSE, BB.hidden_size)).astype(np.float32))
    x.requires_grad_(True)
    leaves = tree_leaves(tp["encoder"])
    for t in leaves:
        t.requires_grad_(True)
    try:
        seq, pooled = tbigbird.bigbird_model(
            tp, TBB, inputs_embeds=x, attention_mask=torch.from_numpy(mask),
            deterministic=deterministic, rng=rng, remat=remat, attention_type=attention_type)
        grads = torch.autograd.grad((seq * w).sum() + pooled.sum(), [x] + leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return seq.detach(), grads


@pytest.mark.parametrize("attention_type", ["block_sparse", "original_full"])
@pytest.mark.parametrize("mode", MODES)
def test_bigbird_remat_equals_none_with_dropout(bb_params, mode, attention_type):
    tp = bigbird_params_from_jax(bb_params, TBB)
    r0, r1 = tpre.step_rng(7, 0, "cpu"), tpre.step_rng(7, 0, "cpu")
    out0, g0 = _bigbird_grads(tp, "none", r0, attention_type)
    out1, g1 = _bigbird_grads(tp, mode, r1, attention_type)
    _assert_same([out1], [out0], "sequence output")
    _assert_same(g1, g0, "gradient")
    assert torch.equal(r1.host.get_state(), r0.host.get_state())
    assert torch.equal(r1.device.get_state(), r0.device.get_state())


@pytest.mark.parametrize("mode", ["none", "full", "attention", "unroll"])
def test_encode_remat_matches_jax(params, mode):
    """Each mode against the JAX package's same mode, deterministic: the
    output and its gradients with respect to the input and every leaf."""
    x, mask, w = _encoder_inputs(3)
    stacked = jax.tree.map(jnp.asarray, params["trunk"]["encoder"])

    def jloss(enc, xj):
        out = jbert.encode({"encoder": enc}, BERT, xj, jnp.asarray(mask.numpy()),
                           deterministic=True, remat=mode)
        return (out * jnp.asarray(w.numpy())).sum(), out

    (_, jout), (jg_enc, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        stacked, jnp.asarray(x.numpy()))
    tp = bert_params_from_jax(params["trunk"], TCFG.bert)
    out, grads = _encode_grads(tp, mode, None, deterministic=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_x), **GRAD_TOL)
    want = tree_leaves(bert_params_from_jax(
        {"encoder": jax.tree.map(np.asarray, jg_enc)}, TCFG.bert)["encoder"])
    assert len(want) == len(grads) - 1
    for i, (g, wl) in enumerate(zip(grads[1:], want)):
        np.testing.assert_allclose(g.numpy(), wl.numpy(), err_msg=f"leaf {i}", **GRAD_TOL)


@pytest.mark.parametrize("mode", ["none", "full", "attention", "unroll"])
def test_bigbird_remat_matches_jax(bb_params, mode):
    rs = np.random.default_rng(1)
    x = rs.normal(size=(3, S_SPARSE, BB.hidden_size)).astype(np.float32)
    mask = np.ones((3, S_SPARSE), np.int64)
    mask[1, 20:] = 0
    w = rs.normal(size=(3, S_SPARSE, BB.hidden_size)).astype(np.float32)

    def jloss(xj):
        seq, pooled = jbigbird.bigbird_model(
            jax.tree.map(jnp.asarray, bb_params), BB, inputs_embeds=xj,
            attention_mask=jnp.asarray(mask), deterministic=True, remat=mode,
            attention_type="block_sparse")
        return (seq * jnp.asarray(w)).sum() + pooled.sum(), seq

    (_, jseq), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tp = bigbird_params_from_jax(bb_params, TBB)
    seq, grads = _bigbird_grads(tp, mode, None, "block_sparse", deterministic=True)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), **FWD_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg), **GRAD_TOL)


@pytest.mark.parametrize("remat, mode", [
    (False, "none"), (None, "none"), ("none", "none"), ("unroll", "none"),
    (True, "full"), ("full", "full"), ("attention", "attention"),
])
def test_remat_mode_and_resolve_train_impl(remat, mode):
    """The JAX package's values; ``resolve_train_impl`` keeps a mode and
    resolves "auto" (and None or True) to none."""
    assert tbert.remat_mode(remat) == mode
    if remat in (None, True):
        assert tpre.resolve_train_impl(remat) == (False, "flash")
    else:
        assert tpre.resolve_train_impl(remat) == (False if mode == "none" else mode, "flash")


def test_unknown_remat_and_attention_raise():
    for bad in ("auto", "selective", 2):
        with pytest.raises(ValueError, match="remat"):
            tbert.remat_mode(bad)
    assert tpre.resolve_train_impl("auto", "xla") == (False, "flash")
    with pytest.raises(ValueError, match="remat"):
        tpre.resolve_train_impl("selective")
    with pytest.raises(ValueError, match="attention_impl"):
        tpre.resolve_train_impl("auto", "pallas")


def test_no_grad_and_frozen_backbones_are_not_checkpointed(params, monkeypatch):
    """Under ``torch.no_grad()`` (evaluation, the frozen backbones) nothing
    is checkpointed; in a training loss only the trunk's layers are."""
    calls = []
    real = tbert.checkpointed

    def counting(fn, x, rng):
        calls.append(x.shape)
        return real(fn, x, rng)

    monkeypatch.setattr(tbert, "checkpointed", counting)
    tp = bert_params_from_jax(params["trunk"], TCFG.bert)
    x, mask, _ = _encoder_inputs(3)
    with torch.no_grad():
        tbert.encode(tp, TCFG.bert, x, mask, deterministic=False,
                     rng=tpre.step_rng(0, 0, "cpu"), remat="full")
    assert calls == []
    full = params_from_jax(params, TCFG)
    batch = tpre.to_device(features(CFG, 2, seed=5), "cpu")
    for t in tree_leaves(full["trunk"]):
        t.requires_grad_(True)
    tstonkgs.pretraining_loss(full, TCFG, batch, deterministic=False,
                              rng=tpre.step_rng(0, 0, "cpu"), remat="full")
    assert calls == [(2, CFG.seq_len, BERT.hidden_size)] * BERT.num_hidden_layers
