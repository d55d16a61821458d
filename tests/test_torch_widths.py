"""The port at head widths 16 and 32 and at hidden widths other than 768
and 1024, against the JAX package, on the CPU.

The card's attention kernels take any D from 8 to 256 (the widths from 48
up are ``tests/test_torch_head_widths.py``'s, those above 128
``tests/test_torch_widest.py``'s) and its FFN kernels any H and I from 8
up (the widths that are no multiple of 32 and those above 1024 are
``tests/test_torch_ffn_widths.py``'s, those above 2048
``tests/test_torch_widest.py``'s); on a
CPU tensor each wrapper runs its kernel's plain version, which these
tests hold against the JAX package's Pallas kernels in interpret mode at
the new widths, and the port's STonKGs at MiniLM-L12-H384's widths
(H=384, 12 heads of D=32, I=1536, vocabulary 30,522; 2 layers, S=32)
against the JAX model through ``params_from_jax``.  The kernels
themselves are held against the plain versions on the card by
``chip_smoke.py`` phase 26.  Inputs come from numpy seeds.

Tolerances, fp32: attention atol 1e-5 / rtol 1e-4 (with the hash dropout
at rate 0.1 as well, which is only possible when both masks agree bit for
bit); the FFN atol 1e-5 / rtol 1e-4 (the JAX kernel's Abramowitz-Stegun
erf is off by < 1.5e-7, and sums run in another order), its gradients
within 1e-5 of their largest magnitude (sums over rows and columns in
another order: the weight gradients reach |13| at H=384); the model's
outputs atol 1e-4 / rtol 1e-4 and the loss rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.ops import flash_attention as jflash
from stonkgs_tpu.ops import fused_ffn as jffn
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.ops import flash_attention as tflash
from stonkgs_tpu_torch.ops import fused_ffn as tffn
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import params_from_jax

ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
FFN_TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_SCALE_TOL = 1e-5
SEED_WORDS = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)

# MiniLM-L12-H384 (microsoft/MiniLM-L12-H384-uncased, config.json) cut to
# 2 layers, dropout 0 (the JAX package's hidden dropout draws on
# jax.random and cannot be matched)
MINILM = jconfig.BertConfig(
    vocab_size=30522, hidden_size=384, num_hidden_layers=2, num_attention_heads=12,
    intermediate_size=1536, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG = jconfig.STonKGsConfig(bert=MINILM, kg_vocab_size=101, text_len=16, entity_len=16)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def port_cfg(cfg):
    """The port's config with the same fields as a JAX-package config."""
    d = dataclasses.asdict(cfg)
    return tconfig.STonKGsConfig(**{**d, "bert": tconfig.BertConfig(**d["bert"])})


# ---------------------------------------------------------------------------
# the domain functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,takes", [(4, True), (8, True), (16, True), (32, True),
                                     (48, True), (64, True), (68, True), (128, True),
                                     (136, True), (256, True), (264, True), (0, False),
                                     (-8, False), (1, True), (2, True), (7, True), (300, True),
                                     (384, True), (768, True), (2560, True)])
def test_attention_kernel_domain(D, takes):
    assert tflash.attention_kernel_takes(D) is takes
    if takes:
        tflash.check_attention_shape("flash_attention_infer", 512, D)
    else:
        with pytest.raises(ValueError, match=rf"takes any D from 1 up .* got D={D}"):
            tflash.check_attention_shape("flash_attention_infer", 512, D)


def test_attention_kernel_refuses_empty_sequences():
    with pytest.raises(ValueError, match="S >= 1, got D=32, S=0"):
        tflash.check_attention_shape("flash_attention_train_fwd", 0, 32)


@pytest.mark.parametrize("H,I,takes", [
    (32, 128, True), (64, 256, True), (96, 384, True), (384, 1536, True), (512, 2048, True),
    (768, 3072, True), (1024, 4096, True), (768, 1000, True), (16, 64, True),
    (48, 192, True), (1056, 4224, True), (384, 100, True), (0, 0, False),
    (8, 8, True), (2048, 8192, True), (2056, 8224, True), (768, 8200, True), (4, 16, True),
    (2560, 10240, True), (8192, 32768, True), (16, 4, True), (0, 16, False), (16, 0, False),
    (1, 1, True), (2, 8, True), (6, 24, True), (7, 7, True)])
def test_ffn_kernel_domain(H, I, takes):
    assert tffn.ffn_kernel_takes(H, I) is takes
    if takes:
        tffn.check_ffn_widths("fused_ffn_fwd", H, I)
    else:
        with pytest.raises(ValueError,
                           match=rf"takes H and I from 1 up, got H={H}, I={I}"):
            tffn.check_ffn_widths("fused_ffn_fwd", H, I)


@pytest.mark.parametrize("name,cfg,takes", [
    ("BERT-base", tconfig.BertConfig(), True),
    ("ProtBERT", tconfig.BertConfig(hidden_size=1024, num_attention_heads=16,
                                    intermediate_size=4096), True),
    ("MiniLM-L12-H384", tconfig.BertConfig(**dataclasses.asdict(MINILM)), True),
    # the NLP baseline at H=384 (it trains in fp32 by default, through the
    # fp32 FFN backward)
    ("NLP baseline fp32 H=384", tconfig.BertConfig(hidden_size=384, num_attention_heads=12,
                                                   intermediate_size=1536), True),
    # the configs the CLI derives from 32- and 64-wide KG vectors
    ("CLI 32-wide", tconfig.BertConfig(hidden_size=32, num_attention_heads=2,
                                       intermediate_size=128), True),
    ("CLI 64-wide", tconfig.BertConfig(hidden_size=64, num_attention_heads=2,
                                       intermediate_size=256), True),
    # ... and from 96-, 160-, 288- and 544-wide ones: 2 heads of D=48 and
    # 80, 4 of 72, 8 of 68
    ("CLI 96-wide", tconfig.BertConfig(hidden_size=96, num_attention_heads=2,
                                       intermediate_size=384), True),
    ("CLI 160-wide", tconfig.BertConfig(hidden_size=160, num_attention_heads=2,
                                        intermediate_size=640), True),
    ("CLI 288-wide", tconfig.BertConfig(hidden_size=288, num_attention_heads=4,
                                        intermediate_size=1152), True),
    ("CLI 544-wide", tconfig.BertConfig(hidden_size=544, num_attention_heads=8,
                                        intermediate_size=2176), True),
    # BERT-base's widths split into 6 heads of D=128
    ("BERT-base 6 x 128", tconfig.BertConfig(num_attention_heads=6), True),
    # a 48-wide config (H is not a multiple of 32, which the FFN kernels
    # take since they take any H from 8 up) ...
    ("CLI 48-wide", tconfig.BertConfig(hidden_size=48, num_attention_heads=2,
                                       intermediate_size=192), True),
    # ... 4 heads of 136, a 2112-wide config (H above 2048) and the CLI's
    # 2560-wide one (40 heads of 64, I = 10,240) ...
    ("H=544 4 x 136", tconfig.BertConfig(hidden_size=544, num_attention_heads=4,
                                         intermediate_size=2176), True),
    ("CLI 2112-wide", tconfig.BertConfig(hidden_size=2112, num_attention_heads=33,
                                         intermediate_size=8448), True),
    ("CLI 2560-wide", tconfig.BertConfig(hidden_size=2560, num_attention_heads=40,
                                         intermediate_size=10240), True),
    # ... 2 heads of 272 (D above 256, outside until every D was taken) ...
    ("H=544 2 x 272", tconfig.BertConfig(hidden_size=544, num_attention_heads=2,
                                         intermediate_size=2176), True),
    # ... the CLI's 8- and 4-wide configs (2 heads of 4 and of 2; H = 4)
    # and BERT-base's widths in 2 heads of 384
    ("CLI 8-wide", tconfig.BertConfig(hidden_size=8, num_attention_heads=2,
                                      intermediate_size=32), True),
    ("CLI 4-wide", tconfig.BertConfig(hidden_size=4, num_attention_heads=2,
                                      intermediate_size=16), True),
    ("BERT-base 2 x 384", tconfig.BertConfig(num_attention_heads=2), True),
])
def test_model_configs_against_the_domains(name, cfg, takes):
    both = (tflash.attention_kernel_takes(cfg.head_dim)
            and tffn.ffn_kernel_takes(cfg.hidden_size, cfg.intermediate_size))
    assert both is takes, name


def test_cli_configs_reach_the_new_widths():
    """The configs ``stonkgs_pretraining_config`` derives from 32- and
    64-wide KG vectors run at D=16 and D=32."""
    from stonkgs_tpu_torch.cli.pretrain import stonkgs_pretraining_config

    feats = {"input_ids": np.zeros((2, 512), np.int64)}
    for hidden, D in ((32, 16), (64, 32)):
        bert = stonkgs_pretraining_config(feats, "stonkgs", hidden, 28996).bert
        assert (bert.hidden_size, bert.head_dim, bert.intermediate_size) == (hidden, D,
                                                                             4 * hidden)
        assert tflash.attention_kernel_takes(bert.head_dim)
        assert tffn.ffn_kernel_takes(bert.hidden_size, bert.intermediate_size)


# ---------------------------------------------------------------------------
# attention at D = 16 and 32
# ---------------------------------------------------------------------------

def _attn_arrays(S, D, B=2, H=2, dead_row=False):
    """q, k, v, a (B, 1, 1, S) key bias and an output weight; with
    ``dead_row`` the last batch row's keys are all at -1e9 (the training
    kernels pad S as the TPU kernel does, so such a row matches; the
    inference kernels do not model the padding)."""
    rng = np.random.default_rng(300 + S + D)
    q, k, v, w = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(4))
    keep = rng.random((B, S)) > 0.2
    keep[:, :1] = True
    if dead_row:
        keep[-1] = False
    bias = ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, w


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("S", [1, 65])
def test_flash_attention_infer_matches_pallas_kernel(S, D):
    q, k, v, bias, _ = _attn_arrays(S, D)
    want = jflash.flash_attention_infer(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                        block_q=32, interpret=True)
    launches = tflash.flash_attention_infer.launches
    got = tflash.flash_attention_infer(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert tflash.flash_attention_infer.launches == launches  # CPU: no kernel
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_train_matches_pallas_kernel(D, rate):
    """Forward output and the four gradients, S=40 (S_pad 64 at block_q
    32), with the hash dropout at rate 0.1."""
    q, k, v, bias, w = _attn_arrays(40, D, dead_row=True)

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


# ---------------------------------------------------------------------------
# the FFN at H = 32, 96 and 384
# ---------------------------------------------------------------------------

def _ffn_arrays(M, H):
    rng = np.random.default_rng(400 + H)
    I, f = 4 * H, np.float32
    return [rng.normal(size=(M, H)).astype(f), rng.normal(size=(M, H)).astype(f),
            (1.0 + 0.1 * rng.normal(size=H)).astype(f), (0.1 * rng.normal(size=H)).astype(f),
            (0.1 * rng.normal(size=(H, I))).astype(f), (0.1 * rng.normal(size=I)).astype(f),
            (0.1 * rng.normal(size=(I, H))).astype(f), (0.1 * rng.normal(size=H)).astype(f),
            (1.0 + 0.1 * rng.normal(size=H)).astype(f), (0.1 * rng.normal(size=H)).astype(f),
            rng.normal(size=(M, H)).astype(f)]


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
@pytest.mark.parametrize("H", [32, 96, 384])
def test_fused_ffn_ln_block_matches_pallas_kernel(H, act):
    a = _ffn_arrays(19, H)[:10]
    want = jffn.fused_ffn_ln_block(*(jnp.asarray(x) for x in a), act=act, eps=1e-12,
                                   block_m=16, interpret=True)
    got = tffn.fused_ffn_ln_block(*(torch.from_numpy(x) for x in a), act=act, eps=1e-12)
    np.testing.assert_allclose(_np(got), _np(want), **FFN_TOL)


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
@pytest.mark.parametrize("H", [32, 96, 384])
def test_fused_ffn_matches_pallas_kernels(H, act, monkeypatch):
    """The training forward and the backward's five gradients (the JAX
    backward through its kernel)."""
    a = _ffn_arrays(19, H)
    x, w1, b1, w2, b2, g = a[0], a[4], a[5], a[6], a[7], a[10]
    monkeypatch.setattr(jffn, "BWD_IMPL", "kernel")
    want, vjp = jax.vjp(lambda *p: jffn.fused_ffn(*p, act=act, block_m=16, interpret=True),
                        *(jnp.asarray(t) for t in (x, w1, b1, w2, b2)))
    want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(t).requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    got = tffn.fused_ffn(*targs, act=act)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), _np(want), **FFN_TOL)
    for name, t, wg in zip(("x", "w1", "b1", "w2", "b2"), targs, want_grads):
        want_g = _np(wg)
        np.testing.assert_allclose(_np(t.grad), want_g, err_msg=name, rtol=0.0,
                                   atol=GRAD_SCALE_TOL * max(1.0, float(np.abs(want_g).max())))


# ---------------------------------------------------------------------------
# STonKGs at MiniLM-L12-H384's widths
# ---------------------------------------------------------------------------

def _features(n, seed):
    rng = np.random.default_rng(seed)
    tl, el = CFG.text_len, CFG.entity_len
    lengths = rng.integers(4, tl + 1, n)
    keep = np.arange(tl)[None, :] < lengths[:, None]
    text = np.where(keep, rng.integers(4, MINILM.vocab_size, (n, tl)), 0)
    mlm = np.full((n, tl), -100, np.int64)
    elm = np.full((n, el), -100, np.int64)
    for i in range(n):
        mlm[i, rng.choice(tl, 2, replace=False)] = rng.integers(0, MINILM.vocab_size, 2)
        elm[i, rng.choice(el, 2, replace=False)] = rng.integers(0, CFG.kg_vocab_size, 2)
    return {
        "input_ids": np.concatenate(
            [text, rng.integers(0, CFG.kg_vocab_size, (n, el))], 1).astype(np.int32),
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
    """JAX-initialised STonKGs params at MiniLM's widths with a random KG
    table, as numpy."""
    p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(0), CFG)
    p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(1),
                                         (CFG.kg_table_size, MINILM.hidden_size))
    return jax.tree.map(np.asarray, p)


def test_minilm_trunk_and_pooled_output_match_jax(params):
    batch = _features(3, seed=1)
    inputs = {k: batch[k] for k in ("input_ids", "attention_mask", "token_type_ids")}
    tcfg = port_cfg(CFG)
    tp = params_from_jax(params, tcfg)
    tb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in inputs.items()}
    jseq, _ = jstonkgs.trunk_forward(params, CFG, **{k: jnp.asarray(v)
                                                     for k, v in inputs.items()})
    tseq, _ = tstonkgs.trunk_forward(tp, tcfg, **tb)
    assert tseq.shape == (3, 32, 384)
    np.testing.assert_allclose(_np(tseq), np.asarray(jseq), **MODEL_TOL)
    want = jstonkgs.pooler_output(params, CFG, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tstonkgs.pooler_output(tp, tcfg, tb)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)


def test_minilm_pretraining_loss_matches_jax(params):
    """The pre-training loss and its parts in training mode (the training
    kernels' plain versions) at D=32, H=384."""
    batch = _features(2, seed=2)
    jl, jm = jstonkgs.pretraining_loss(
        params, CFG, {k: jnp.asarray(v) for k, v in batch.items()}, deterministic=False,
        dropout_rng=jax.random.PRNGKey(0))
    tcfg = port_cfg(CFG)
    tl, tm = tstonkgs.pretraining_loss(params_from_jax(params, tcfg), tcfg,
                                       tpre.to_device(batch, "cpu"), deterministic=False,
                                       rng=tpre.step_rng(0, 0, "cpu"))
    assert np.isfinite(float(jl))
    for k in ("loss", "mlm_loss", "elm_loss", "nsp_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# ProtSTonKGs from a KG TSV that is not 768 wide: the derived config and
# its loss (the BigBird pair at D = 16 and 32 and block S // 8)
# ---------------------------------------------------------------------------

class _Derived(Exception):
    """Carries the config the JAX package's run derives out of it."""


def _prot_feature_rows(layout, n=2, kg_rows=128, seed=0):
    """Tri-modality rows at ``layout`` (text, entity, protein lengths) with
    every label column, entity ids below ``kg_rows``."""
    rng = np.random.default_rng(seed)
    tl, el, pl = layout
    ids = np.concatenate([rng.integers(0, 28996, (n, tl)), rng.integers(0, kg_rows, (n, el)),
                          rng.integers(0, 30, (n, pl))], 1)
    out = {"input_ids": ids.astype(np.int64),
           "attention_mask": np.ones((n, sum(layout)), np.int64)}
    for name, length in (("masked_lm_labels", tl), ("ent_masked_lm_labels", el),
                         ("prot_masked_lm_labels", pl)):
        out[name] = np.full((n, length), -100, np.int64)
    return out


def _jax_prot_config(feats, width, tmp_path, monkeypatch):
    """The ProtSTonKGs config the JAX package's ``run_pretraining(variant=
    "prot")`` derives from ``feats`` and a ``width``-wide KG TSV (its
    ``pretrain`` replaced by one that hands the config back)."""
    import importlib

    from stonkgs_tpu.train import pretraining as jpre

    emb = tmp_path / f"emb{width}.tsv"
    vecs = np.random.default_rng(width).normal(size=(128, width)).astype(np.float32)
    emb.write_text("".join(f"node{i}\t" + "\t".join(repr(float(x)) for x in v) + "\n"
                           for i, v in enumerate(vecs)))

    def capture(cfg, *a, **kw):
        raise _Derived(cfg)

    monkeypatch.setattr(jpre, "pretrain", capture)
    jcli = importlib.import_module("stonkgs_tpu.cli.pretrain")
    with pytest.raises(_Derived) as got:
        jcli._run_prot_pretraining(feats, kg_embedding_path=str(emb), compute_dtype="float32",
                                   output_dir=str(tmp_path / f"run{width}"))
    return got.value.args[0]


@pytest.mark.parametrize("layout", [(120, 72, 192), (384, 128, 256), (768, 256, 3072)],
                         ids=["S384", "S768", "S4096"])
@pytest.mark.parametrize("width", [32, 64, 128])
def test_prot_pretraining_config_matches_jax(width, layout, tmp_path, monkeypatch):
    """``prot_pretraining_config`` equals the JAX package's derived config
    field for field, and every stack it derives lies in the kernels'
    domains: the BigBird pair (head width, block S // 8, at least 5
    blocks) and the dense attention and FFN kernels."""
    from stonkgs_tpu_torch.cli.pretrain import prot_pretraining_config
    from stonkgs_tpu_torch.ops import bigbird_sparse as tsparse

    feats = _prot_feature_rows(layout)
    want = _jax_prot_config(feats, width, tmp_path, monkeypatch)
    got = prot_pretraining_config(feats, width)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    t, S = got.trunk, sum(layout)
    assert (t.block_size, t.num_random_blocks, t.head_dim) == (S // 8, 1, width // t.num_attention_heads)
    assert tsparse.bigbird_kernel_takes(t.block_size, t.head_dim, S)
    for bert in (got.lm, got.prot):
        assert tflash.attention_kernel_takes(bert.head_dim)
        assert tffn.ffn_kernel_takes(bert.hidden_size, bert.intermediate_size)
    assert tffn.ffn_kernel_takes(t.hidden_size, t.intermediate_size)


def test_bigbird_kernel_domain_edges():
    """The BigBird pair's domain: any D and block size from 1, and (given
    S) S a multiple of the block size of at least 5 blocks."""
    from stonkgs_tpu_torch.ops import bigbird_sparse as tsparse

    takes = tsparse.bigbird_kernel_takes
    for bs in (*range(1, 130), 200, 1020, 1024, 1032, 2048, 4096):
        for D in (1, 4, 7, 8, 16, 24, 32, 36, 64, 72, 128, 520):
            assert takes(bs, D) and takes(bs, D, 5 * bs) and takes(bs, D, 8 * bs)
            assert not takes(bs, D, 4 * bs)
            if bs > 1:
                assert not takes(bs, D, 8 * bs + 1)
    for bs in (4, 12, 60, 100, 1020, 1032, 2048):   # refused until the block rule went
        assert takes(bs, 32) and takes(bs, 32, 8 * bs)
    for D in (*range(1, 8), *range(65, 129), 200, 256, 384, 520):   # ... and the width rule
        assert takes(64, D) and takes(512, D)
    for bs in (0, -8):
        assert not takes(bs, 32)
    for D in (0, -1):
        assert not takes(64, D) and not takes(64, D, 512)
    assert not takes(64, 32, 0) and not takes(25, 32, 100) and not takes(25, 32, 210)


# the derived 128-wide config, cut: 2 rows of S=384 laid out 120 | 72 | 192
# (block 48, 8 blocks, 4 heads of D=32), every dropout 0; the text in 3
# chunks of 40
PROT_WIDE_LAYOUT = (120, 72, 192)


def _prot_wide_configs():
    from stonkgs_tpu_torch.cli.pretrain import prot_pretraining_config

    feats = _prot_feature_rows(PROT_WIDE_LAYOUT)
    tcfg = prot_pretraining_config(feats, 128)
    zero = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tcfg = tcfg.replace(trunk=dataclasses.replace(tcfg.trunk, **zero),
                        lm=dataclasses.replace(tcfg.lm, **zero),
                        prot=dataclasses.replace(tcfg.prot, **zero))
    d = dataclasses.asdict(tcfg)
    jcfg = jconfig.ProtSTonKGsConfig(**{
        **d, "trunk": jconfig.BigBirdConfig(**d["trunk"]),
        "lm": jconfig.BertConfig(**d["lm"]), "prot": jconfig.BertConfig(**d["prot"])})
    return jcfg, tcfg


def test_prot_derived_128_wide_loss_and_grads_match_jax():
    """The derived 128-wide ProtSTonKGs (2 layers a stack, 4 heads of D=32,
    block 48 at S=384: the pair's partial 64-row tiles) in training mode
    at dropout 0: the loss and the trunk, projection and head gradients
    against the JAX package's (XLA sparse path), fp32."""
    from stonkgs_tpu.models import protstonkgs as jprot
    from stonkgs_tpu_torch.models import protstonkgs as tprot
    from stonkgs_tpu_torch.models.bigbird import effective_attention_type
    from stonkgs_tpu_torch.utils.convert import bigbird_params_from_jax, \
        protstonkgs_params_from_jax
    from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

    jcfg, tcfg = _prot_wide_configs()
    assert effective_attention_type(tcfg.trunk, tcfg.seq_len) == "block_sparse"
    assert (tcfg.trunk.block_size, tcfg.trunk.head_dim) == (48, 32)
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: jprot.init_protstonkgs_params(k, jcfg))(key)
    params["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(1),
                                              (jcfg.kg_table_size, jcfg.trunk.hidden_size))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(7)
    tl, el, pl = PROT_WIDE_LAYOUT
    n = 2
    batch = {"input_ids": np.concatenate([rng.integers(0, jcfg.lm_vocab_size, (n, tl)),
                                          rng.integers(0, jcfg.kg_table_size, (n, el)),
                                          rng.integers(0, jcfg.prot_vocab_size, (n, pl))], 1),
             "attention_mask": np.ones((n, jcfg.seq_len), np.int64)}
    batch["attention_mask"][1, 300:] = 0       # a pad inside a middle block
    for name, a, b, vocab in (("masked_lm_labels", 0, tl, jcfg.lm_vocab_size),
                              ("ent_masked_lm_labels", tl, tl + el, jcfg.kg_vocab_size),
                              ("prot_masked_lm_labels", tl + el, jcfg.seq_len,
                               jcfg.prot_vocab_size)):
        lab = np.full((n, b - a), -100, np.int64)
        for i in range(n):
            k = max(int((b - a) * 0.15), 1)
            lab[i, rng.choice(b - a, k, replace=False)] = rng.integers(0, vocab, k)
        batch[name] = lab
    train_keys = ("trunk", "prot_projection", "cls")
    jp = jax.tree.map(jnp.asarray, params)
    frozen = {k: v for k, v in jp.items() if k not in train_keys}

    def jloss(train):
        return jprot.pretraining_loss({**train, **frozen}, jcfg,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      deterministic=False, dropout_rng=jax.random.PRNGKey(0))

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jp[k] for k in train_keys})
    tp = protstonkgs_params_from_jax(params, tcfg)
    leaves = tree_leaves({k: tp[k] for k in train_keys})
    for t in leaves:
        t.requires_grad_(True)
    tl_, tm = tprot.pretraining_loss(tp, tcfg, tpre.to_device(batch, "cpu"), deterministic=False,
                                     rng=tpre.step_rng(0, 0, "cpu"))
    grads = torch.autograd.grad(tl_, leaves, allow_unused=True)
    for k in ("loss", "text_loss", "entity_loss", "prot_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, rtol=1e-5, atol=1e-5)
    jg = jax.tree.map(np.asarray, jg)
    want = {"trunk": bigbird_params_from_jax(jg["trunk"], tcfg.trunk)}
    for k in ("prot_projection", "cls"):
        want[k] = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), jg[k])
    want = tree_leaves(want)
    got = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"grad leaf {i}",
                                   atol=2e-5, rtol=1e-4)
