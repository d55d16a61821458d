"""The port's models against the JAX package at fp32, on the CPU.

Weights come from the JAX ``init_*`` functions and reach the port through
``params_from_jax``; inputs are made with a numpy seed.  Tolerance: atol
1e-4 and rtol 1e-4, because the two frameworks sum in another order
through every layer.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import bert as jbert
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.models import bert as tbert
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.utils.convert import bert_params_from_jax, params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)

BERT = jconfig.BertConfig(
    vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=32,
)
# the smallest KG vocabulary whose table holds the special rows 100/102/103
CFG = jconfig.STonKGsConfig(bert=BERT, kg_vocab_size=101, text_len=16,
                            entity_len=16, num_labels=3)
TRANSE = CFG.replace(entity_len=4)


def port_cfg(cfg):
    """The port's config with the same fields as a JAX-package config."""
    d = dataclasses.asdict(cfg)
    if "bert" not in d:
        return tconfig.BertConfig(**d)
    return tconfig.STonKGsConfig(**{**d, "bert": tconfig.BertConfig(**d["bert"])})


def jax_params(cfg, seed=0):
    """JAX-initialised STonKGs params (with classifier and a random KG
    table), as a tree of numpy arrays."""
    p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(seed), cfg,
                                     with_classifier=True)
    p["kg_backbone"] = jax.random.normal(
        jax.random.PRNGKey(seed + 1), (cfg.kg_table_size, cfg.bert.hidden_size))
    return jax.tree.map(np.asarray, p)


def features(cfg, lengths, seed=0):
    """Dual-modality features whose text halves have the given true lengths."""
    rng = np.random.default_rng(seed)
    n, tl, el = len(lengths), cfg.text_len, cfg.entity_len
    text = rng.integers(4, cfg.bert.vocab_size, (n, tl))
    keep = np.arange(tl)[None, :] < np.asarray(lengths)[:, None]
    text = np.where(keep, text, 0)
    ent = rng.integers(0, cfg.kg_vocab_size, (n, el))
    return {
        "input_ids": np.concatenate([text, ent], 1).astype(np.int32),
        "attention_mask": np.concatenate(
            [keep.astype(np.int32), np.ones((n, el), np.int32)], 1),
        "token_type_ids": np.concatenate(
            [np.zeros((n, tl), np.int32), np.ones((n, el), np.int32)], 1),
    }


@pytest.fixture(scope="module")
def params():
    return jax_params(CFG)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64)
            for k, v in batch.items()}


@pytest.mark.parametrize("mode", ["full", "cls_only", "position_ids"])
def test_bert_model_matches_jax(params, mode):
    rng = np.random.default_rng(1)
    B, S = 3, 12
    ids = rng.integers(0, BERT.vocab_size, (B, S))
    mask = (np.arange(S)[None, :] < np.array([[12], [5], [9]])).astype(np.int32)
    tt = rng.integers(0, 2, (B, S))
    kw = {"cls_only": mode == "cls_only"}
    pos = None
    if mode == "position_ids":
        pos = np.concatenate([np.arange(4), np.arange(20, 28)])[None]
    jseq, jpool = jbert.bert_model(
        params["trunk"], BERT, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), token_type_ids=jnp.asarray(tt),
        position_ids=None if pos is None else jnp.asarray(pos), **kw)
    tp = bert_params_from_jax(params["trunk"], port_cfg(BERT))
    tseq, tpool = tbert.bert_model(
        tp, port_cfg(BERT), input_ids=torch.as_tensor(ids),
        attention_mask=torch.as_tensor(mask), token_type_ids=torch.as_tensor(tt),
        position_ids=None if pos is None else torch.as_tensor(pos), **kw)
    assert tseq.shape == jseq.shape
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), **TOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **TOL)


def test_bert_inputs_embeds_path(params):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(2, 6, BERT.hidden_size)).astype(np.float32)
    jseq, _ = jbert.bert_model(params["trunk"], BERT, inputs_embeds=jnp.asarray(emb))
    tp = bert_params_from_jax(params["trunk"], port_cfg(BERT))
    tseq, _ = tbert.bert_model(tp, port_cfg(BERT), inputs_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), **TOL)


def test_training_arguments_raise(params):
    """What training does not take raises: an unknown remat mode (the
    modes themselves are held in ``tests/test_torch_remat.py``), and
    ``cls_only`` in the training half of classification, which runs the
    whole trunk (that half is held against the JAX package in
    ``tests/test_torch_finetuning.py``)."""
    tp = bert_params_from_jax(params["trunk"], port_cfg(BERT))
    ids = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="remat"):
        tbert.bert_model(tp, port_cfg(BERT), input_ids=ids, deterministic=False,
                         remat="selective")
    batch = _t(features(CFG, [3], seed=0))
    with pytest.raises(ValueError, match="cls_only"):
        tstonkgs.classification_logits(params_from_jax(params, port_cfg(CFG)),
                                       port_cfg(CFG), batch, deterministic=False,
                                       cls_only=True)


def test_init_params_match_jax_layout(params):
    """The port's own init gives the tree that params_from_jax gives, with
    weights drawn from a seeded torch.Generator."""
    tcfg = port_cfg(CFG)
    ours = tstonkgs.init_stonkgs_params(torch.Generator().manual_seed(0), tcfg,
                                        with_classifier=True)
    ref = params_from_jax(params, tcfg)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), ours)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), ref)
    w = ours["trunk"]["encoder"][0]["intermediate"]["kernel"]
    assert 0 < float(w.abs().max()) <= 2 * BERT.initializer_range
    again = tbert.init_bert_params(torch.Generator().manual_seed(0), port_cfg(BERT))
    assert torch.equal(again["embeddings"]["word_embeddings"],
                       ours["trunk"]["embeddings"]["word_embeddings"])


def test_build_kg_table_matches_jax(params):
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(CFG.kg_vocab_size, BERT.hidden_size)).astype(np.float32)
    want = np.asarray(jstonkgs.build_kg_table(params["lm_backbone"], BERT, vecs))
    lm = bert_params_from_jax(params["lm_backbone"], port_cfg(BERT))
    got = tstonkgs.build_kg_table(lm, port_cfg(BERT), vecs).numpy()
    assert got.shape == (CFG.kg_table_size, BERT.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)
    for row in (100, 102, 103):   # the LM-derived special rows
        assert np.abs(got[row]).sum() > 0
    np.testing.assert_array_equal(
        tstonkgs.kg_row_permutation(CFG.kg_vocab_size),
        jstonkgs.kg_row_permutation(CFG.kg_vocab_size))


@pytest.mark.parametrize("cfg", [CFG, TRANSE], ids=["16+16", "transe-16+4"])
def test_pooler_and_classification_match_jax(cfg, params):
    p = params if cfg is CFG else jax_params(cfg, seed=4)
    batch = features(cfg, [16, 3, 9, 1], seed=5)
    tcfg = port_cfg(cfg)
    tp = params_from_jax(p, tcfg)
    want_pool = np.asarray(jstonkgs.pooler_output(p, cfg, _j(batch)))
    want_logits = np.asarray(jstonkgs.classification_logits(p, cfg, _j(batch)))
    got_pool = tstonkgs.pooler_output(tp, tcfg, _t(batch))
    got_logits = tstonkgs.classification_logits(tp, tcfg, _t(batch))
    np.testing.assert_allclose(got_pool.numpy(), want_pool, **TOL)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, **TOL)
    # the full-sequence trunk output as well (no cls_only)
    jseq, _ = jstonkgs.trunk_forward(p, cfg, **{k: jnp.asarray(v) for k, v in batch.items()})
    tseq, _ = tstonkgs.trunk_forward(tp, tcfg, **_t(batch))
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), **TOL)
