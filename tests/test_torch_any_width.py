"""The port at the last widths the JAX package runs and its earlier
domains refused, against the JAX package, on the CPU.

The card's kernels now take BigBird at any block size (4, 12 and 25 here:
the command line's ``block_size = max(S // 8, 4)`` at S = 32, 96 and 200)
and any head width (4, 72 and 128 here), attention at any D (4 below the
old floor of 8; 264, 300, 384, 520 and 768 past the old cap of 256, where
the bf16 forward's Hopper kernel cuts O into column parts of 128: one
column past 256, no multiple of 8, two heads of BERT-base's 768, three
parts the last ragged, one head of 768) and the FFN at H or
I below 8 ((4, 16), the 4-wide config's, and (16, 4)).  On a CPU tensor
each wrapper runs its kernel's plain version, which these tests hold
against the JAX function at the same width: the Pallas kernel in
interpret mode where the JAX package's own tests run it so (attention,
the FFN), else the path the JAX package takes on the CPU (BigBird's
``block_sparse_attention``, its XLA lowering, which takes every block
size; its Pallas kernel takes none of 4, 12 and 25).
Then 1-layer models against the JAX package's: ProtSTonKGs at the config
the command line derives from a 64-wide KG TSV at S = 200 (block 25, 2
heads of 32; ``trunk_forward`` and ``pretraining_loss``), and STonKGs at
the configs it derives from 8- and 4-wide KG TSVs (2 heads of 4; H = 4 in
2 heads of 2) and at BERT-base's widths in 2 heads of 384
(``pooler_output`` and ``pretraining_loss``).  The kernels themselves are
held against the plain versions on the card by ``chip_smoke.py`` phases
27-29.  Inputs come from numpy seeds.

Tolerances, fp32, as ``tests/test_torch_bigbird.py`` and
``tests/test_torch_widest.py``: the BigBird forward within 1e-5 absolute,
its gradients within 2e-5 absolute + 1e-4 relative; attention atol 1e-5 /
rtol 1e-4 (with the hash dropout at rate 0.1, which is only possible when
both masks agree bit for bit), its gradients within 1e-5 of their largest
magnitude (or of √D: dS = p (dP - delta) subtracts two sums of D products
of unit-scale values, of order √D, so at S = 1, where dbias is zero but
for that rounding, the two frameworks' 1e-5-sized remainders differ); the
FFN atol 1e-5 / rtol 1e-4 and its gradients within 1e-5 of their largest
magnitude (or of 1); the models' outputs atol 1e-4 / rtol 1e-4, the
losses rtol 1e-5 (ProtSTonKGs atol 1e-5 too).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import protstonkgs as jprot
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.ops import bigbird_sparse as jsparse
from stonkgs_tpu.ops import flash_attention as jflash
from stonkgs_tpu.ops import fused_ffn as jffn
from stonkgs_tpu_torch.cli.pretrain import prot_pretraining_config
from stonkgs_tpu_torch.models import protstonkgs as tprot
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.ops import bigbird_sparse as tsparse
from stonkgs_tpu_torch.ops import flash_attention as tflash
from stonkgs_tpu_torch.ops import fused_ffn as tffn
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import params_from_jax, protstonkgs_params_from_jax
from test_torch_ffn_widths import _ffn_arrays
from test_torch_head_widths import SEED_WORDS, _attn_arrays, _features, _np, port_cfg
from test_torch_widest import _numpy_params
from test_torch_widths import _prot_feature_rows

SPARSE_FWD_TOL = dict(atol=1e-5, rtol=0)
SPARSE_GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
FFN_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_SCALE_TOL = 1e-5
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _scaled_close(got, want, name, floor=1.0):
    """Within GRAD_SCALE_TOL of the largest magnitude of ``want`` (or of
    ``floor``)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, err_msg=name, rtol=0.0,
                               atol=GRAD_SCALE_TOL * max(floor, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# the BigBird pair's plain versions at any block size and head width
# ---------------------------------------------------------------------------

# (block size, head width): the command line's blocks at S = 32, 96 and
# 200 (no multiple of 8) at D = 8, and D = 4 (padded to 8 on the card), 72
# and 128 (the SIMT bodies' column parts) at block 16; 2 batch rows, 2
# heads, 6 blocks, one random block (the command line's), a padded mask
SPARSE_CASES = [(4, 8), (12, 8), (25, 8), (16, 4), (16, 72), (16, 128)]
SPARSE_IDS = [f"bs{bs}-D{d}" for bs, d in SPARSE_CASES]


def _sparse_inputs(bs, d, seed, nb=6, r=1, heads=2):
    rng = np.random.default_rng(seed)
    S = nb * bs
    q, k, v, w = (rng.normal(size=(2, heads, S, d)).astype(np.float32) * 0.5
                  for _ in range(4))
    mask = np.ones((2, S), np.float32)
    mask[0, -(bs + 2):] = 0.0              # a pad crossing the last block boundary
    mask[1, 2 * bs + 1:2 * bs + 3] = 0.0   # a pad inside a middle block
    rand = rng.integers(1, nb - 1, (heads, nb - 2, r)).astype(np.int32)
    return q, k, v, rand, mask, w


@pytest.mark.parametrize("bs,d", SPARSE_CASES, ids=SPARSE_IDS)
def test_block_sparse_attention_and_gradients_match_jax(bs, d):
    """The forward and the q/k/v cotangents of ``block_sparse_attention``
    (the kernel pair's plain versions) against JAX autodiff through its
    XLA lowering."""
    assert tsparse.bigbird_kernel_takes(bs, d, 6 * bs)
    q, k, v, rand, mask, w = _sparse_inputs(bs, d, seed=bs * 1000 + d)
    jr, jm = jnp.asarray(rand), jnp.asarray(mask)

    def fwd_and_vjp(q, k, v, w):
        out, vjp = jax.vjp(lambda *a: jsparse.block_sparse_attention(*a, jr, jm, bs), q, k, v)
        return out, vjp(w)

    want, want_grads = jax.jit(fwd_and_vjp)(q, k, v, w)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tsparse.block_sparse_attention(tq, tk, tv, rand, torch.from_numpy(mask), bs)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **SPARSE_FWD_TOL)
    for x, got, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(g), err_msg=f"d{x}",
                                   **SPARSE_GRAD_TOL)


# ---------------------------------------------------------------------------
# the attention kernels' plain versions at D = 4 and 264 ... 768
# ---------------------------------------------------------------------------

HEAD_DIMS = [4, 264, 300, 384, 520, 768]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 65])
def test_flash_attention_infer_matches_jax(S, D):
    assert tflash.attention_kernel_takes(D)
    q, k, v, bias, _ = _attn_arrays(S, D)
    want = jflash.flash_attention_infer(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                        block_q=32, interpret=True)
    got = tflash.flash_attention_infer(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [1, 65])
def test_flash_attention_train_matches_jax(S, D, rate):
    """Forward output and the four gradients, with the hash dropout at
    rate 0.1 and a row whose keys are all at -1e9."""
    q, k, v, bias, w = _attn_arrays(S, D, dead_row=True)

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
        _scaled_close(g, wg, name, floor=np.sqrt(D))


@pytest.mark.parametrize("D,dtype,takes", [(264, torch.bfloat16, True),
                                            (768, torch.bfloat16, True),
                                            (256, torch.bfloat16, False),
                                            (384, torch.float32, False)])
def test_wide_forward_statistics_scratch(D, dtype, takes):
    """The bf16 forward past D = 256 takes its rows' softmax statistics
    from a launch of its own: the wrapper hands the kernel a (B, H, S) x 2
    fp32 scratch for them (none below, or in fp32)."""
    q = torch.zeros(2, 5, 3, D, dtype=dtype)
    stats = tflash._wide_stats(q)
    assert (stats is not None) == takes
    if takes:
        assert stats.shape == (2, 3, 5, 2) and stats.dtype == torch.float32


# (B, S, H, D, dtype, scratch cap in bytes, the plan expected): past D =
# 256 in bf16 a group of every head at the trunk's shape, groups of fewer
# heads, one head in chunks of 128 rows (the last ragged) and of 256, none
# at D = 256 or in fp32
WIDE_BWD_PLANS = [
    (32, 512, 2, 384, torch.bfloat16, 1 << 30, (64, 512)),
    (3, 100, 2, 264, torch.bfloat16, 4 * 100 * 104 * 4, (4, 100)),
    (2, 300, 3, 768, torch.bfloat16, 4 * 300 * 128, (1, 128)),
    (1, 600, 1, 304, torch.bfloat16, 4 * 600 * 300, (1, 256)),
    (1, 100, 1, 264, torch.bfloat16, 8, (1, 100)),
    (4, 512, 3, 256, torch.bfloat16, 1 << 30, None),
    (4, 512, 2, 384, torch.float32, 1 << 30, None),
]


@pytest.mark.parametrize("B,S,H,D,dtype,cap,want", WIDE_BWD_PLANS)
def test_wide_backward_plan_covers_each_head_and_row_once(B, S, H, D, dtype, cap, want):
    """The bf16 backward past D = 256 writes round(dS) and the dropped P
    into a bf16 scratch of 4 · group · S · ⌈chunk⌉₈ bytes: its plan takes
    as many heads a group as the cap allows, or one head in chunks of
    query rows (multiples of 128), and its launch groups cover each head
    and query row exactly once within the cap (or one 128-row chunk where
    even that passes it); no plan at D = 256 or in fp32."""
    plan = tflash.wide_backward_plan(B, S, H, D, dtype, cap=cap)
    assert plan == want
    if plan is None:
        return
    group, chunk = plan
    assert chunk == S or chunk % tflash.WIDE_BWD_ROWS == 0
    assert 4 * group * S * (-(-chunk // 8) * 8) <= cap or (group, chunk) == (
        1, min(S, tflash.WIDE_BWD_ROWS))
    covered = np.zeros((B * H, S), np.int64)
    for g0, n_bh, q0, n_q in tflash.wide_backward_pieces(B, S, H, plan):
        assert 1 <= n_bh <= group and 1 <= n_q <= chunk
        covered[g0:g0 + n_bh, q0:q0 + n_q] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("S,chunk,carries", [(300, 300, False), (300, 128, True),
                                             (301, 301, False)])
def test_wide_backward_scratch(S, chunk, carries):
    """The scratch the wrapper hands the backward past D = 256: dS and the
    dropped P, each (group, S, ⌈chunk⌉₈) bf16 (keys by query rows), and
    fp32 (B, S, H, D) carries of dK and dV only where a chunk is shorter
    than S; none at D = 256 or in fp32."""
    q = torch.zeros(2, S, 3, 384, dtype=torch.bfloat16)
    ds, pd, dk_carry, dv_carry = tflash._wide_bwd_scratch(q, (4, chunk))
    for t in (ds, pd):
        assert t.shape == (4, S, -(-chunk // 8) * 8) and t.dtype == torch.bfloat16
    assert (dk_carry is not None) == (dv_carry is not None) == carries
    if carries:
        for t in (dk_carry, dv_carry):
            assert t.shape == (2, S, 3, 384) and t.dtype == torch.float32
    assert tflash._wide_bwd_scratch(q, None) == (None, None, None, None)
    for D, dtype in ((256, torch.bfloat16), (384, torch.float32)):
        assert tflash.wide_backward_plan(2, S, 3, D, dtype) is None


@pytest.mark.parametrize("D,dtype,takes", [(136, torch.bfloat16, True),
                                            (384, torch.bfloat16, True),
                                            (128, torch.bfloat16, False),
                                            (72, torch.bfloat16, False),
                                            (256, torch.float32, False)])
def test_bigbird_wide_forward_statistics_scratch(D, dtype, takes):
    """The bf16 BigBird forward past D = 128 (more than one output part of
    128 columns) takes its rows' softmax statistics from a launch of its
    own: the wrapper hands the kernel a (B, H, (nb - 2) bs) x 2 fp32
    scratch for them; none up to 128, where one launch runs both passes,
    or in fp32."""
    q = torch.zeros(2, 5 * 4, 3, D, dtype=dtype)
    stats = tsparse._wide_stats(q, 3 * 4)
    assert (stats is not None) == takes
    if takes:
        assert stats.shape == (2, 3, 12, 2) and stats.dtype == torch.float32


# ---------------------------------------------------------------------------
# the FFN kernels' plain versions at H or I below 8
# ---------------------------------------------------------------------------

FFN_WIDTHS = [(4, 16), (16, 4)]
FFN_ROWS = 5


@pytest.mark.parametrize("H,I", FFN_WIDTHS)
def test_fused_ffn_ln_block_matches_jax(H, I):
    """The serving block's plain version against the JAX block."""
    assert tffn.ffn_kernel_takes(H, I)
    a = _ffn_arrays(FFN_ROWS, H, I)[:10]
    want = jffn.fused_ffn_ln_block(*(jnp.asarray(x) for x in a), act="gelu", eps=1e-12,
                                   block_m=32, interpret=True)
    got = tffn.fused_ffn_ln_block(*(torch.from_numpy(x) for x in a), act="gelu", eps=1e-12)
    np.testing.assert_allclose(_np(got), _np(want), **FFN_TOL)


@pytest.mark.parametrize("H,I", FFN_WIDTHS)
def test_fused_ffn_and_its_gradients_match_jax(H, I, monkeypatch):
    """The training forward and the backward's five gradients against the
    JAX custom VJP, its backward asked for the kernel."""
    a = _ffn_arrays(FFN_ROWS, H, I)
    x, w1, b1, w2, b2, g = a[0], a[4], a[5], a[6], a[7], a[10]
    monkeypatch.setattr(jffn, "BWD_IMPL", "kernel")
    want, vjp = jax.vjp(lambda *p: jffn.fused_ffn(*p, act="gelu_new", block_m=32,
                                                   interpret=True),
                        *(jnp.asarray(t) for t in (x, w1, b1, w2, b2)))
    want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(t).requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    got = tffn.fused_ffn(*targs, act="gelu_new")
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), _np(want), **FFN_TOL)
    for name, t, wg in zip(("x", "w1", "b1", "w2", "b2"), targs, want_grads):
        _scaled_close(t.grad, wg, name)


# ---------------------------------------------------------------------------
# 1-layer models at the configs that reach the new widths
# ---------------------------------------------------------------------------

def _stonkgs_cfg(hidden, heads, inter, vocab=1024):
    """A 1-layer STonKGs config at 16 + 16 tokens, dropout 0."""
    return jconfig.STonKGsConfig(
        bert=jconfig.BertConfig(vocab_size=vocab, hidden_size=hidden, num_hidden_layers=1,
                                num_attention_heads=heads, intermediate_size=inter,
                                max_position_embeddings=64, **NO_DROPOUT),
        kg_vocab_size=101, text_len=16, entity_len=16)


# what ``stonkgs_pretraining_config`` derives from 8- and 4-wide KG vectors
# (max(H // 64, 2) = 2 heads, I = 4H), cut to 1 layer and a vocabulary of
# 1,024; BERT-base's widths in 2 heads of 384
STONKGS_CFGS = {"H8": _stonkgs_cfg(8, 2, 32), "H4": _stonkgs_cfg(4, 2, 16),
                "2x384": _stonkgs_cfg(768, 2, 3072)}


@pytest.mark.parametrize("name", list(STONKGS_CFGS))
def test_stonkgs_pooled_output_and_loss_match_jax(name):
    """The pooled output and the deterministic pre-training loss and its
    parts: attention at D = 4, 2 and 384, the FFN at H = 8 and 4."""
    cfg = STONKGS_CFGS[name]
    tcfg = port_cfg(cfg)
    assert tflash.attention_kernel_takes(tcfg.bert.head_dim)
    assert tffn.ffn_kernel_takes(tcfg.bert.hidden_size, tcfg.bert.intermediate_size)
    params = _numpy_params(cfg)
    tp = params_from_jax(params, tcfg)
    batch = _features(cfg, 2, seed=6)
    inputs = {k: v for k, v in batch.items()
              if k in ("input_ids", "attention_mask", "token_type_ids")}
    want = jax.jit(lambda p, b: jstonkgs.pooler_output(p, cfg, b))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tstonkgs.pooler_output(tp, tcfg, {k: torch.as_tensor(v, dtype=torch.int64)
                                            for k, v in inputs.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    jl, jm = jax.jit(lambda p, b: jstonkgs.pretraining_loss(p, cfg, b, deterministic=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = tstonkgs.pretraining_loss(tp, tcfg, tpre.to_device(batch, "cpu"),
                                       deterministic=True)
    assert np.isfinite(float(jl))
    for k in ("loss", "mlm_loss", "elm_loss", "nsp_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)


# the command line's store at S = 200 (text | entity | protein): block 25
PROT_S200_LAYOUT = (96, 48, 56)


def test_prot_s200_trunk_and_loss_match_jax():
    """ProtSTonKGs at the config ``prot_pretraining_config`` derives from a
    64-wide KG TSV at S = 200 (block 25, 8 blocks, 2 heads of 32), 1 layer
    a stack, dropout 0: ``trunk_forward``'s sequence and pooled outputs
    (eval mode) and the pre-training loss and its parts (the training
    plan) against the JAX package's, whose XLA sparse path takes block 25."""
    feats = _prot_feature_rows(PROT_S200_LAYOUT)
    tcfg = prot_pretraining_config(feats, 64)
    one = dict(num_hidden_layers=1, **NO_DROPOUT)
    tcfg = tcfg.replace(trunk=dataclasses.replace(tcfg.trunk, **one),
                        lm=dataclasses.replace(tcfg.lm, **one),
                        prot=dataclasses.replace(tcfg.prot, **one))
    t = tcfg.trunk
    assert (t.block_size, t.head_dim, tcfg.seq_len) == (25, 32, 200)
    assert tsparse.bigbird_kernel_takes(t.block_size, t.head_dim, tcfg.seq_len)
    d = dataclasses.asdict(tcfg)
    jcfg = jconfig.ProtSTonKGsConfig(**{
        **d, "trunk": jconfig.BigBirdConfig(**d["trunk"]),
        "lm": jconfig.BertConfig(**d["lm"]), "prot": jconfig.BertConfig(**d["prot"])})
    params = jax.jit(lambda k: jprot.init_protstonkgs_params(k, jcfg))(jax.random.PRNGKey(0))
    params["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(1),
                                              (jcfg.kg_table_size, jcfg.trunk.hidden_size))
    params = jax.tree.map(np.asarray, params)
    tp = protstonkgs_params_from_jax(params, tcfg)
    rng = np.random.default_rng(8)
    tl, el, pl = PROT_S200_LAYOUT
    n = 2
    batch = {"input_ids": np.concatenate([rng.integers(0, jcfg.lm_vocab_size, (n, tl)),
                                          rng.integers(0, jcfg.kg_table_size, (n, el)),
                                          rng.integers(0, jcfg.prot_vocab_size, (n, pl))], 1),
             "attention_mask": np.ones((n, jcfg.seq_len), np.int64)}
    batch["attention_mask"][1, 160:] = 0       # a pad inside a middle block
    jseq, jpooled = jax.jit(lambda p, ids, m: jprot.trunk_forward(p, jcfg, ids, m))(
        params, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]))
    tseq, tpooled = tprot.trunk_forward(tp, tcfg, torch.from_numpy(batch["input_ids"]),
                                        torch.from_numpy(batch["attention_mask"]))
    np.testing.assert_allclose(_np(tseq), np.asarray(jseq), **MODEL_TOL)
    np.testing.assert_allclose(_np(tpooled), np.asarray(jpooled), **MODEL_TOL)
    for name, a, b, vocab in (("masked_lm_labels", 0, tl, jcfg.lm_vocab_size),
                              ("ent_masked_lm_labels", tl, tl + el, jcfg.kg_vocab_size),
                              ("prot_masked_lm_labels", tl + el, jcfg.seq_len,
                               jcfg.prot_vocab_size)):
        lab = np.full((n, b - a), -100, np.int64)
        for i in range(n):
            k = max(int((b - a) * 0.15), 1)
            lab[i, rng.choice(b - a, k, replace=False)] = rng.integers(0, vocab, k)
        batch[name] = lab
    jl, jm = jax.jit(lambda p, b: jprot.pretraining_loss(p, jcfg, b, deterministic=False,
                                                         dropout_rng=jax.random.PRNGKey(0)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tprot.pretraining_loss(tp, tcfg, tpre.to_device(batch, "cpu"), deterministic=False,
                                   rng=tpre.step_rng(0, 0, "cpu"))
    assert np.isfinite(float(jl))
    for k in ("loss", "text_loss", "entity_loss", "prot_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, rtol=1e-5, atol=1e-5)
