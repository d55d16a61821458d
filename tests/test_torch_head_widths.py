"""The port's attention at head widths from 8 to 128 against the JAX
package, on the CPU.

The card's attention kernels take any head width D from 8 to 128 (a D
that is not a multiple of 8 in zero-padded copies); on a CPU tensor each
wrapper runs its kernel's plain version, which these tests hold against
the JAX package's Pallas kernels in interpret mode at D = 24, 48, 68, 72,
80 and 128: the widths the command line derives from 96-, 160-, 288- and
544-wide KG vectors (2 heads of 48 and 80, 4 of 72, 8 of 68), BERT-base's
768 split into 6 heads of 128, and 24 (inside the 32-wide instance).
Then the configs the command line derives at those widths, equal to the
JAX package's; STonKGs at BERT-base's widths with 6 heads (2 layers, 64 +
64 tokens) and the derived 160-wide model, against the JAX models through
``params_from_jax``.  The kernels themselves are held against the plain
versions on the card by ``chip_smoke.py`` phase 28.  Inputs come from
numpy seeds.

Tolerances, fp32, as ``tests/test_torch_widths.py``: attention atol 1e-5 /
rtol 1e-4 (with the hash dropout at rate 0.1 too, which is only possible
when both masks agree bit for bit, and the masks themselves equal); the
models' outputs atol 1e-4 / rtol 1e-4, the loss rtol 1e-5, gradients
within 1e-5 of each leaf's largest magnitude (or of 1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.ops import flash_attention as jflash
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.cli.pretrain import stonkgs_pretraining_config
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.ops import flash_attention as tflash
from stonkgs_tpu_torch.ops import fused_ffn as tffn
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import bert_params_from_jax, params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_SCALE_TOL = 1e-5
SEED_WORDS = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)
HEAD_DIMS = [24, 48, 68, 72, 80, 128]
# the KG TSV widths and the head widths of the configs derived from them
TSV_WIDTHS = {96: 48, 160: 80, 288: 72, 544: 68}
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def port_cfg(cfg):
    """The port's config with the same fields as a JAX-package config."""
    d = dataclasses.asdict(cfg)
    return tconfig.STonKGsConfig(**{**d, "bert": tconfig.BertConfig(**d["bert"])})


def jax_cfg(cfg):
    """The JAX package's config with the same fields as a port config."""
    d = dataclasses.asdict(cfg)
    return jconfig.STonKGsConfig(**{**d, "bert": jconfig.BertConfig(**d["bert"])})


# ---------------------------------------------------------------------------
# the attention functions at D = 24 ... 128
# ---------------------------------------------------------------------------

def _attn_arrays(S, D, B=2, H=2, dead_row=False):
    """q, k, v, a (B, 1, 1, S) key bias and an output weight; with
    ``dead_row`` the last batch row's keys are all at -1e9 (the training
    kernels pad S as the TPU kernel does, so such a row matches)."""
    rng = np.random.default_rng(500 + S + D)
    q, k, v, w = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(4))
    keep = rng.random((B, S)) > 0.2
    keep[:, :1] = True
    if dead_row:
        keep[-1] = False
    bias = ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, w


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 65])
def test_flash_attention_infer_matches_pallas_kernel(S, D):
    q, k, v, bias, _ = _attn_arrays(S, D)
    want = jflash.flash_attention_infer(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                        block_q=32, interpret=True)
    launches = tflash.flash_attention_infer.launches
    got = tflash.flash_attention_infer(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert tflash.flash_attention_infer.launches == launches  # CPU: no kernel
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_train_matches_pallas_kernel(D, rate):
    """Forward output and the four gradients, S=65 (S_pad 96 at block_q
    32), with the hash dropout at rate 0.1 and a row whose keys are all
    at -1e9."""
    q, k, v, bias, w = _attn_arrays(65, D, dead_row=True)

    def jloss(q, k, v, b):
        out = jflash.flash_attention_train(q, k, v, b, dropout_rate=rate,
                                           dropout_rng=jnp.asarray(SEED_WORDS), block_q=32,
                                           interpret=True)
        return jnp.sum(out * w), out

    (_, want), want_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias))
    got = tflash.flash_attention_train(tq, tk, tv, tb, dropout_rate=rate,
                                       seed=torch.from_numpy(SEED_WORDS.view(np.int32)),
                                       block_q=32)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)
    for name, g, wg in zip(("dq", "dk", "dv", "dbias"), (tq.grad, tk.grad, tv.grad, tb.grad),
                           want_grads):
        np.testing.assert_allclose(_np(g), _np(wg), err_msg=name, **ATTN_TOL)


def _pallas_keep(B, H, S_pad, bq, rate):
    """The keep mask that the JAX package's training kernels draw, as
    (B, H, S_pad, S_pad) bools: its ``_dropout_keep`` run in a kernel of
    their grid (b, h, q-block), in interpret mode."""
    def kernel(seed_ref, o_ref):
        o_ref[0, 0] = jflash._dropout_keep(seed_ref, (bq, S_pad), rate).astype(jnp.int32)

    keep = pl.pallas_call(
        kernel, grid=(B, H, S_pad // bq),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, 1, bq, S_pad), lambda b, h, i: (b, h, i, 0)),
        out_shape=jax.ShapeDtypeStruct((B, H, S_pad, S_pad), jnp.int32),
        interpret=True)(jnp.asarray(SEED_WORDS.view(np.int32)))
    return np.asarray(keep).astype(bool)


@pytest.mark.parametrize("S", [1, 65])
def test_dropout_keep_mask_is_the_pallas_kernels(S):
    """The hash mask of the port's kernels and plain versions equals the
    JAX kernels' bit for bit over the padded (S_pad, S_pad) grid of every
    (b, h): it depends on the position and the seed, not on D."""
    B, H, bq = 2, 2, 32
    s_pad = tflash.padded_length(S, bq)
    want = _pallas_keep(B, H, s_pad, min(bq, S), 0.1)
    idx = torch.arange(s_pad)
    got = tflash.dropout_keep_plain(torch.from_numpy(SEED_WORDS.view(np.int32)), B, H, s_pad,
                                    idx, idx, 0.1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.8 < want.mean() < 0.97 or S == 1


@pytest.mark.parametrize("D", [68, 12, 128])
def test_heads_are_padded_to_a_multiple_of_8(D):
    """The wrappers' copies for the kernels: a head width that is not a
    multiple of 8 gains zero columns up to the next one (TMA's strides
    are multiples of 16 bytes), which the outputs lose again; a multiple
    of 8 is passed as it is."""
    x = torch.randn(2, 5, 3, D)
    (padded, none) = tflash._pad_heads(x, None)
    assert none is None
    assert padded.shape[-1] == -(-D // 8) * 8
    assert torch.equal(padded[..., :D], x)
    assert not padded[..., D:].any()
    (back,) = tflash._unpad(D, padded)
    assert torch.equal(back, x) and back.is_contiguous()
    if D % 8 == 0:
        assert padded is x


# ---------------------------------------------------------------------------
# the configs the command line derives from 96-, 160-, 288- and 544-wide
# KG vectors
# ---------------------------------------------------------------------------

class _Derived(Exception):
    """Carries the config the JAX package's run derives out of it."""


def _derived_features(S=64, n=2, kg_rows=40, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, 28996, (n, S // 2)),
                          rng.integers(0, kg_rows, (n, S // 2))], 1).astype(np.int64)
    ids[0, S // 2] = kg_rows - 1   # the derived KG vocabulary: every row of the TSV
    return {"input_ids": ids, "attention_mask": np.ones((n, S), np.int64),
            "token_type_ids": np.concatenate([np.zeros((n, S // 2), np.int64),
                                              np.ones((n, S // 2), np.int64)], 1)}


def _jax_stonkgs_config(feats, width, tmp_path, monkeypatch):
    """The STonKGs config the JAX package's ``run_pretraining`` derives
    from a memmap store of ``feats`` and a ``width``-wide KG TSV (its
    ``init_stonkgs_params`` replaced by one that hands the config back)."""
    import importlib

    from stonkgs_tpu.data.memmap_dataset import MemmapFeatureStore

    jcli = importlib.import_module("stonkgs_tpu.cli.pretrain")

    store = tmp_path / f"store{width}"
    MemmapFeatureStore.write(str(store), feats)
    emb = tmp_path / f"emb{width}.tsv"
    vecs = np.random.default_rng(width).normal(size=(40, width)).astype(np.float32)
    emb.write_text("".join(f"node{i}\t" + "\t".join(repr(float(x)) for x in v) + "\n"
                           for i, v in enumerate(vecs)))

    def capture(key, cfg):
        raise _Derived(cfg)

    monkeypatch.setattr(jstonkgs, "init_stonkgs_params", capture)
    with pytest.raises(_Derived) as got:
        jcli.run_pretraining(str(store), kg_embedding_path=str(emb),
                             output_dir=str(tmp_path / f"run{width}"))
    return got.value.args[0]


@pytest.mark.parametrize("width", sorted(TSV_WIDTHS))
def test_stonkgs_pretraining_config_matches_jax(width, tmp_path, monkeypatch):
    """``stonkgs_pretraining_config`` equals the JAX package's derived
    config field for field at the new widths, and every width lies in the
    dense kernels' domains: attention at D = 48, 80, 72 or 68, the FFN at
    H = 96, 160, 288 or 544 with I = 4H."""
    feats = _derived_features()
    want = _jax_stonkgs_config(feats, width, tmp_path, monkeypatch)
    got = stonkgs_pretraining_config(feats, "stonkgs", width, 28996)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    bert = got.bert
    assert (bert.hidden_size, bert.head_dim, bert.intermediate_size) == (
        width, TSV_WIDTHS[width], 4 * width)
    assert tflash.attention_kernel_takes(bert.head_dim)
    assert tffn.ffn_kernel_takes(bert.hidden_size, bert.intermediate_size)


# ---------------------------------------------------------------------------
# STonKGs at BERT-base's widths with 6 heads of 128, and the derived
# 160-wide model
# ---------------------------------------------------------------------------

# BERT-base's widths (12 x 768, I=3072) with 6 heads, cut to 2 layers, 64 +
# 64 tokens and a vocabulary of 1,024 (the JAX package's initialiser takes
# seconds at 28,996), dropout 0 (the JAX package's hidden dropout draws on
# jax.random and cannot be matched)
BASE6 = jconfig.BertConfig(vocab_size=1024, num_hidden_layers=2, num_attention_heads=6,
                           **NO_DROPOUT)
CFG6 = jconfig.STonKGsConfig(bert=BASE6, kg_vocab_size=101, text_len=64, entity_len=64)


def _features(cfg, n, seed):
    rng = np.random.default_rng(seed)
    tl, el, vocab = cfg.text_len, cfg.entity_len, cfg.bert.vocab_size
    lengths = rng.integers(4, tl + 1, n)
    keep = np.arange(tl)[None, :] < lengths[:, None]
    text = np.where(keep, rng.integers(4, vocab, (n, tl)), 0)
    mlm = np.full((n, tl), -100, np.int64)
    elm = np.full((n, el), -100, np.int64)
    for i in range(n):
        mlm[i, rng.choice(tl, int(tl * 0.15), replace=False)] = rng.integers(
            0, vocab, int(tl * 0.15))
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


def _jax_params(cfg, seed=0):
    """JAX-initialised STonKGs params with a random KG table, as numpy."""
    p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(seed), cfg)
    p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                         (cfg.kg_table_size, cfg.bert.hidden_size))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def params6():
    return _jax_params(CFG6)


def test_bert_base_6_heads_trunk_and_pooled_output_match_jax(params6):
    """The trunk's sequence output and the pooled output at D=128."""
    inputs = {k: v for k, v in _features(CFG6, 3, seed=1).items()
              if k in ("input_ids", "attention_mask", "token_type_ids")}
    tcfg = port_cfg(CFG6)
    assert tcfg.bert.head_dim == 128
    tp = params_from_jax(params6, tcfg)
    tb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in inputs.items()}
    jseq, _ = jstonkgs.trunk_forward(params6, CFG6, **{k: jnp.asarray(v)
                                                       for k, v in inputs.items()})
    tseq, _ = tstonkgs.trunk_forward(tp, tcfg, **tb)
    assert tseq.shape == (3, 128, 768)
    np.testing.assert_allclose(_np(tseq), np.asarray(jseq), **MODEL_TOL)
    want = jstonkgs.pooler_output(params6, CFG6, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tstonkgs.pooler_output(tp, tcfg, tb)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)


def test_bert_base_6_heads_pretraining_loss_matches_jax(params6):
    """The pre-training loss and its parts in training mode (the training
    kernels' plain versions) at D=128."""
    batch = _features(CFG6, 2, seed=2)
    jl, jm = jax.jit(lambda p, b: jstonkgs.pretraining_loss(
        p, CFG6, b, deterministic=False, dropout_rng=jax.random.PRNGKey(0)))(
        params6, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = port_cfg(CFG6)
    tl, tm = tstonkgs.pretraining_loss(params_from_jax(params6, tcfg), tcfg,
                                       tpre.to_device(batch, "cpu"), deterministic=False,
                                       rng=tpre.step_rng(0, 0, "cpu"))
    assert np.isfinite(float(jl))
    for k in ("loss", "mlm_loss", "elm_loss", "nsp_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)


def test_derived_160_wide_loss_and_grads_match_jax():
    """The config ``stonkgs_pretraining_config`` derives from 160-wide KG
    vectors (2 layers, 2 heads of D=80, I=640; 32 + 32 tokens here),
    dropout 0, in training mode: the loss and the trunk's and heads'
    gradients against the JAX package's."""
    feats = _derived_features(S=64, n=3, kg_rows=40, seed=3)
    tcfg = stonkgs_pretraining_config(feats, "stonkgs", 160, 28996)
    tcfg = tcfg.replace(bert=dataclasses.replace(tcfg.bert, **NO_DROPOUT))
    assert (tcfg.bert.head_dim, tcfg.text_len, tcfg.kg_vocab_size) == (80, 32, 40)
    jcfg = jax_cfg(tcfg)
    batch = {**feats, **{k: v for k, v in _features(jcfg, 3, seed=4).items()
                         if k.endswith("labels")}}
    params = _jax_params(jcfg, seed=2)
    jp = jax.tree.map(jnp.asarray, params)
    frozen = {k: jp[k] for k in ("lm_backbone", "kg_backbone")}

    def jloss(train):
        return jstonkgs.pretraining_loss(
            {**train, **frozen}, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
            deterministic=False, dropout_rng=jax.random.PRNGKey(0))

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {"trunk": jp["trunk"], "cls": jp["cls"]})
    tp = params_from_jax(params, tcfg)
    leaves = tree_leaves({"trunk": tp["trunk"], "cls": tp["cls"]})
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = tstonkgs.pretraining_loss(tp, tcfg, tpre.to_device(batch, "cpu"),
                                       deterministic=False, rng=tpre.step_rng(0, 0, "cpu"))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    for k in ("loss", "mlm_loss", "elm_loss", "nsp_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    jg = jax.tree.map(np.asarray, jg)
    want = tree_leaves({"trunk": bert_params_from_jax(jg["trunk"], tcfg.bert),
                        "cls": tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                                        jg["cls"])})
    got = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"grad leaf {i}", rtol=0.0,
                                   atol=GRAD_SCALE_TOL * max(1.0, float(np.abs(w).max())))
