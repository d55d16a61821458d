"""The port at hidden widths that are no multiple of 32 or above 1024 and at
BigBird head widths other than 16, 32 and 64, against the JAX package, on
the CPU.

The card's FFN kernels take any H and I from 8 up (those above 2048 are
``tests/test_torch_widest.py``'s), and its BigBird pair any head width D from 8 to 64 (a width that the
padded layout does not hold, in zero-padded copies); on a CPU tensor each
wrapper runs its kernel's plain version, which these tests hold against
the JAX package's Pallas kernels in interpret mode: the three FFN kernels
at H = 16, 48, 100, 112, 144 and 1280 (1280 at 5 rows) with I = 4H and
I = 100, and the BigBird pair at D = 24, 36 and 40.  Then the configs the
command line derives from 48- to 1280-wide KG vectors, equal to the JAX
package's, and the derived STonKGs (100 wide: 2 heads of D=50) and
ProtSTonKGs (48 and 144 wide: heads of D=24 and 36) against the JAX models
through ``params_from_jax``.  The kernels themselves are held against the
plain versions on the card by ``chip_smoke.py`` phase 29.  Inputs come
from numpy seeds.

Tolerances, fp32, as ``tests/test_torch_widths.py`` and
``tests/test_torch_bigbird.py``: the FFN atol 1e-5 / rtol 1e-4, its
gradients within 1e-5 of their largest magnitude (or of 1); the BigBird
forward atol 1e-5, its gradients atol 2e-5 / rtol 1e-4; the models'
losses rtol 1e-5 (ProtSTonKGs: and atol 1e-5) and their gradients within
1e-5 of each leaf's largest magnitude (STonKGs) or atol 2e-5 / rtol 1e-4
(ProtSTonKGs).  bf16: the logit scale 1/√D rounded to bf16 and the scaled
logits bit-equal to JAX's.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.ops import fused_ffn as jffn
from stonkgs_tpu.ops.bigbird_sparse_pallas import block_sparse_attention_pallas
from stonkgs_tpu_torch.cli.pretrain import prot_pretraining_config, stonkgs_pretraining_config
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.ops import bigbird_sparse as tsparse
from stonkgs_tpu_torch.ops import flash_attention as tflash
from stonkgs_tpu_torch.ops import fused_ffn as tffn
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import bert_params_from_jax, params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_head_widths import _derived_features, _jax_stonkgs_config
from test_torch_widths import _Derived, _prot_feature_rows

FFN_TOL = dict(atol=1e-5, rtol=1e-4)
FWD_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_SCALE_TOL = 1e-5
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the derived models cut to one layer a stack, dropout 0 (the JAX
# package's hidden dropout draws on jax.random and cannot be matched)
CUT = dict(num_hidden_layers=1, **NO_DROPOUT)
# the KG TSV widths of the derived configs: STonKGs takes max(H // 64, 2)
# heads, ProtSTonKGs max(H // 32, 2)
TSV_WIDTHS = (48, 80, 100, 112, 144, 1280)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# the FFN kernels' plain versions at H = 16 ... 1280
# ---------------------------------------------------------------------------

# (H, I, rows): I = 4H and I = 100 at each width; H=1280 at 5 rows
FFN_CASES = [(H, I, 5 if H == 1280 else 19) for H in (16, 48, 100, 112, 144, 1280)
             for I in (4 * H, 100)]
FFN_IDS = [f"H{H}-I{I}" for H, I, _ in FFN_CASES]


def _ffn_arrays(M, H, I):
    rng = np.random.default_rng(500 + H + I)
    f = np.float32
    s1, s2 = H ** -0.5, I ** -0.5
    return [rng.normal(size=(M, H)).astype(f), rng.normal(size=(M, H)).astype(f),
            (1.0 + 0.1 * rng.normal(size=H)).astype(f), (0.1 * rng.normal(size=H)).astype(f),
            (s1 * rng.normal(size=(H, I))).astype(f), (0.1 * rng.normal(size=I)).astype(f),
            (s2 * rng.normal(size=(I, H))).astype(f), (0.1 * rng.normal(size=H)).astype(f),
            (1.0 + 0.1 * rng.normal(size=H)).astype(f), (0.1 * rng.normal(size=H)).astype(f),
            rng.normal(size=(M, H)).astype(f)]


@pytest.mark.parametrize("H,I,M", FFN_CASES, ids=FFN_IDS)
def test_fused_ffn_ln_block_matches_pallas_kernel(H, I, M):
    """The serving block's plain version against ``_ffn_ln_kernel``."""
    a = _ffn_arrays(M, H, I)[:10]
    want = jffn.fused_ffn_ln_block(*(jnp.asarray(x) for x in a), act="gelu", eps=1e-12,
                                   block_m=32, interpret=True)
    launches = tffn.fused_ffn_ln_block.launches
    got = tffn.fused_ffn_ln_block(*(torch.from_numpy(x) for x in a), act="gelu", eps=1e-12)
    assert tffn.fused_ffn_ln_block.launches == launches  # CPU: no kernel
    np.testing.assert_allclose(_np(got), _np(want), **FFN_TOL)


@pytest.mark.parametrize("H,I,M", FFN_CASES, ids=FFN_IDS)
def test_fused_ffn_matches_pallas_kernels(H, I, M, monkeypatch):
    """The training forward against ``_ffn_kernel`` and the backward's
    five gradients against the JAX custom VJP through
    ``_ffn_bwd_kernel``."""
    a = _ffn_arrays(M, H, I)
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
        want_g = _np(wg)
        np.testing.assert_allclose(_np(t.grad), want_g, err_msg=name, rtol=0.0,
                                   atol=GRAD_SCALE_TOL * max(1.0, float(np.abs(want_g).max())))


@pytest.mark.parametrize("H,dtype,Hp", [(100, torch.bfloat16, 104), (100, torch.float32, 128),
                                        (48, torch.bfloat16, 48), (48, torch.float32, 64),
                                        (1280, torch.bfloat16, 1280),
                                        (2048, torch.float32, 2048)])
def test_padded_layout(H, dtype, Hp):
    """The kernels' padded layout: rows of a multiple of 8 elements in
    bf16 (TMA's 16-byte strides) and of 32 in fp32; the wrappers' copies
    gain zero columns (and rows) up to it and lose them again, and an
    array already in it is passed as it is."""
    assert tffn.padded_width(H, dtype) == Hp
    w = torch.randn(H, 3 * H, dtype=dtype)
    padded = tffn._pad_to(w, Hp, tffn.padded_width(3 * H, dtype))
    assert padded.shape == (Hp, tffn.padded_width(3 * H, dtype))
    assert torch.equal(padded[:H, :3 * H], w) and not padded[H:].any() \
        and not padded[:, 3 * H:].any()
    x = torch.randn(5, H, dtype=dtype)
    (back,) = tffn._unpad(H, tffn._pad_to(x, Hp))
    assert torch.equal(back, x) and back.is_contiguous()
    if Hp == H:
        assert tffn._pad_to(x, Hp) is x


def test_jax_gate_widest_width_lies_in_the_domain():
    """The widest H at I = 4H at which the JAX package sends the bf16 FFN
    to its Pallas kernels (``ffn_kernel_fits`` at the smallest row block
    it tries, 128, and ``ffn_bwd_kernel_fits``; every narrower H fits as
    well) lies inside the port's FFN domain (any H from 8): 1,635 for the
    training forward, 1,620 for the serving block, 963 for the backward."""
    gates = {"fwd": lambda H: jffn.ffn_kernel_fits(128, H, 4 * H),
             "ln": lambda H: jffn.ffn_kernel_fits(128, H, 4 * H, with_ln_block=True),
             "bwd": lambda H: jffn.ffn_bwd_kernel_fits(128, H, 4 * H)}
    widest = {}
    for name, fits in gates.items():
        taken = [H for H in range(1, 4097) if fits(H)]
        assert taken == list(range(1, len(taken) + 1)), name
        widest[name] = taken[-1]
    assert widest == {"fwd": 1635, "ln": 1620, "bwd": 963}
    for H in range(tffn.FFN_MIN_WIDTH, max(widest.values()) + 1):
        assert tffn.ffn_kernel_takes(H, 4 * H)
    assert tffn.ffn_kernel_takes(2049, 4 * 2049)   # and every wider H since the cap went
    assert not tffn.ffn_kernel_takes(tffn.FFN_MIN_WIDTH - 1, 4 * tffn.FFN_MIN_WIDTH)


# ---------------------------------------------------------------------------
# the BigBird pair's plain versions at D = 24, 36 and 40
# ---------------------------------------------------------------------------

B = 2
# (D, block size, heads, nb, r): a partial block (48) and a whole one (64)
BB_CASES = [(24, 48, 1, 5, 1), (36, 64, 1, 5, 2), (40, 48, 1, 5, 2)]
BB_IDS = [f"D{d}-bs{bs}" for d, bs, _, _, _ in BB_CASES]


def _bb_inputs(nb, r, bs, heads, d, seed):
    rng = np.random.default_rng(seed)
    S = nb * bs
    q, k, v = (rng.normal(size=(B, heads, S, d)).astype(np.float32) * 0.5 for _ in range(3))
    mask = np.ones((B, S), np.float32)
    mask[0, -(bs + 4):] = 0.0            # pad crossing the last block boundary
    mask[1, 2 * bs + 5:2 * bs + 13] = 0.0  # pad inside a middle block
    rand = rng.integers(1, nb - 1, (heads, nb - 2, r)).astype(np.int32)
    w = rng.normal(size=(B, heads, S, d)).astype(np.float32)
    return q, k, v, rand, mask, w


@pytest.mark.parametrize("d,bs,heads,nb,r", BB_CASES, ids=BB_IDS)
def test_block_sparse_matches_pallas_kernels(d, bs, heads, nb, r):
    """``block_sparse_attention`` (the plain pair on the CPU) against the
    JAX package's Pallas pair in interpret mode (``_mid_blocks_kernel``
    forward, ``_mid_blocks_bwd_kernel`` through its custom VJP): forward
    and q, k, v gradients, fp32."""
    q, k, v, rand, mask, w = _bb_inputs(nb, r, bs, heads, d, 600 + d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jr, jm, jw = jnp.asarray(rand), jnp.asarray(mask), jnp.asarray(w)

    def pallas(*a):
        return block_sparse_attention_pallas(*a, jr, jm, bs, interpret=True)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    launches = tsparse.bigbird_mid_fwd.launches, tsparse.bigbird_mid_bwd.launches
    out = tsparse.block_sparse_attention(tq, tk, tv, rand, torch.from_numpy(mask), bs)
    (out * torch.from_numpy(w)).sum().backward()
    assert (tsparse.bigbird_mid_fwd.launches, tsparse.bigbird_mid_bwd.launches) == launches
    want, vjp = jax.vjp(pallas, jq, jk, jv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD_TOL)
    for n_, got, g in zip("qkv", (tq, tk, tv), vjp(jw)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(g), err_msg=f"d{n_}", **GRAD_TOL)


@pytest.mark.parametrize("d", [24, 36, 40])
def test_bf16_logit_scale_of_the_true_width(d):
    """In bf16 the logit scale is 1/√D of the tensors' own D rounded to bf16
    (as JAX multiplies a bf16 array by a Python float), never that of the
    padded width the kernels run at (32 or 64): the scaled logits are
    bit-equal to JAX's, and apart from the padded width's."""
    scale = float(tsparse._scale_in(torch.bfloat16, d))
    assert scale == float(torch.tensor(1.0 / math.sqrt(d)).to(torch.bfloat16))
    padded = float(tsparse._scale_in(torch.bfloat16, 32 if d <= 32 else 64))
    assert scale != 1.0 / math.sqrt(d) and scale != padded
    rng = np.random.default_rng(d)
    x = (rng.normal(size=4096) * 20).astype(np.float32)
    want = np.asarray((jnp.asarray(x).astype(jnp.bfloat16) * (1.0 / d ** 0.5))
                      .astype(jnp.float32))
    got = (torch.from_numpy(x).to(torch.bfloat16) * tsparse._scale_in(torch.bfloat16, d)
           ).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal((torch.from_numpy(x).to(torch.bfloat16) * padded).float().numpy(),
                              want)


@pytest.mark.parametrize("d", [36, 12])
def test_bigbird_heads_are_padded_to_a_multiple_of_8(d):
    """The wrappers' copies for the pair's C entry points: a head width
    that is not a multiple of 8 gains zero columns up to the next one,
    which the outputs lose again; the strides then suit the tensor maps."""
    x = torch.randn(2, 40, 3, d)
    (padded,) = tsparse._pad_heads(x)
    assert padded.shape[-1] == -(-d // 8) * 8 and torch.equal(padded[..., :d], x)
    assert not padded[..., d:].any()
    (back,) = tsparse._unpad(d, padded)
    assert torch.equal(back, x) and back.is_contiguous()
    q, _, _, strides = tsparse._strided_qkv(x, x, x)
    assert q.shape[-1] % 8 == 0 and tsparse.tma_map_args(q.to(torch.bfloat16)) is not None
    assert strides == q.stride()[:3]


# ---------------------------------------------------------------------------
# the configs the command line derives from 48- to 1280-wide KG vectors
# ---------------------------------------------------------------------------

def _kg_tsv(path, width, rows):
    vecs = np.random.default_rng(width).normal(size=(rows, width)).astype(np.float32)
    path.write_text("".join(f"node{i}\t" + "\t".join(repr(float(x)) for x in v) + "\n"
                            for i, v in enumerate(vecs)))


@pytest.mark.parametrize("width", TSV_WIDTHS)
def test_stonkgs_pretraining_config_matches_jax(width, tmp_path, monkeypatch):
    """``stonkgs_pretraining_config`` equals the JAX package's derived
    config field for field, and the derived model lies in the dense
    kernels' domains (the FFN at H = width, I = 4H)."""
    feats = _derived_features()
    want = _jax_stonkgs_config(feats, width, tmp_path, monkeypatch)
    got = stonkgs_pretraining_config(feats, "stonkgs", width, 28996)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    bert = got.bert
    assert (bert.hidden_size, bert.num_attention_heads, bert.intermediate_size) == (
        width, max(width // 64, 2), 4 * width)
    assert tflash.attention_kernel_takes(bert.head_dim)
    assert tffn.ffn_kernel_takes(bert.hidden_size, bert.intermediate_size)


@pytest.mark.parametrize("width", TSV_WIDTHS)
def test_prot_pretraining_config_matches_jax(width, tmp_path, monkeypatch):
    """``prot_pretraining_config`` equals the JAX package's derived config
    field for field (its ``init_protstonkgs_params`` replaced by one that
    hands the config back), and where max(width // 32, 2) heads divide the
    width every stack lies in the kernels' domains: the BigBird pair at
    D = width // heads and block S // 8, the dense attention and FFN.  At
    100 and 112 wide the 3 heads do not divide it: neither package has a
    model to run there."""
    from stonkgs_tpu.models import protstonkgs as jprot

    layout = (384, 128, 256)
    feats = _prot_feature_rows(layout)
    emb = tmp_path / "emb.tsv"
    _kg_tsv(emb, width, 128)

    def capture(key, cfg):
        raise _Derived(cfg)

    monkeypatch.setattr(jprot, "init_protstonkgs_params", capture)
    jcli = importlib.import_module("stonkgs_tpu.cli.pretrain")
    with pytest.raises(_Derived) as derived:
        jcli._run_prot_pretraining(feats, kg_embedding_path=str(emb), compute_dtype="float32",
                                   output_dir=str(tmp_path / "run"))
    want = derived.value.args[0]
    got = prot_pretraining_config(feats, width)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    t, S = got.trunk, sum(layout)
    heads = max(width // 32, 2)
    assert (t.num_attention_heads, t.block_size) == (heads, S // 8)
    if width % heads:
        assert width in (100, 112)
        return
    assert t.head_dim == width // heads
    assert tsparse.bigbird_kernel_takes(t.block_size, t.head_dim, S)
    for bert in (got.lm, got.prot):
        assert tflash.attention_kernel_takes(bert.head_dim)
        assert tffn.ffn_kernel_takes(bert.hidden_size, bert.intermediate_size)
    assert tffn.ffn_kernel_takes(t.hidden_size, t.intermediate_size)


# ---------------------------------------------------------------------------
# the derived models: STonKGs 100 wide, ProtSTonKGs 48 and 144 wide
# ---------------------------------------------------------------------------

def _numpy_params(init, cfg, seed):
    """A JAX-package parameter tree of ``init``'s shapes drawn with numpy
    (LayerNorm scales about 1, every other leaf at std 0.02): the shapes
    come from ``jax.eval_shape``, which compiles nothing."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        x = 0.02 * rng.normal(size=leaf.shape)
        if str(path[-1]) == "['scale']":
            x = 1.0 + 5.0 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _stonkgs_labels(cfg, n, seed):
    rng = np.random.default_rng(seed)
    tl, el, vocab = cfg.text_len, cfg.entity_len, cfg.bert.vocab_size
    mlm = np.full((n, tl), -100, np.int64)
    elm = np.full((n, el), -100, np.int64)
    for i in range(n):
        mlm[i, rng.choice(tl, int(tl * 0.15), replace=False)] = rng.integers(
            0, vocab, int(tl * 0.15))
        elm[i, rng.choice(el, int(el * 0.15), replace=False)] = rng.integers(
            0, cfg.kg_vocab_size, int(el * 0.15))
    return {"masked_lm_labels": mlm, "ent_masked_lm_labels": elm,
            "next_sentence_labels": rng.integers(0, 2, n).astype(np.int64)}


def test_derived_100_wide_loss_and_grads_match_jax():
    """The config ``stonkgs_pretraining_config`` derives from 100-wide KG
    vectors (2 heads of D=50, H=100: a width the bf16 layout pads to 104
    and the fp32 one to 128, I=400; cut to 1 layer, a vocabulary of 1,024
    and 32 + 32 tokens), dropout 0, in training mode: the loss and the
    trunk's and heads' gradients against the JAX package's."""
    feats = _derived_features(S=64, n=3, kg_rows=40, seed=3)
    tcfg = stonkgs_pretraining_config(feats, "stonkgs", 100, 28996)
    tcfg = tcfg.replace(bert=dataclasses.replace(tcfg.bert, vocab_size=1024, **CUT))
    feats["input_ids"][:, :32] %= 1024
    assert (tcfg.bert.head_dim, tcfg.bert.intermediate_size, tcfg.kg_vocab_size) == (50, 400, 40)
    d = dataclasses.asdict(tcfg)
    jcfg = jconfig.STonKGsConfig(**{**d, "bert": jconfig.BertConfig(**d["bert"])})
    batch = {**feats, **_stonkgs_labels(jcfg, 3, seed=4)}
    params = _numpy_params(jstonkgs.init_stonkgs_params, jcfg, seed=2)
    params["kg_backbone"] = np.random.default_rng(3).normal(
        size=(jcfg.kg_table_size, jcfg.bert.hidden_size)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    frozen = {k: jp[k] for k in ("lm_backbone", "kg_backbone")}

    def jloss(train):
        return jstonkgs.pretraining_loss(
            {**train, **frozen}, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
            deterministic=False, dropout_rng=jax.random.PRNGKey(0))

    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
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


# S=192 laid out 72 | 48 | 72: block 24 (8 blocks, the pair's partial
# 64-row tiles), the text in 3 chunks of 24
PROT_LAYOUT = (72, 48, 72)


@pytest.mark.parametrize("width", [48, 144])
def test_prot_derived_loss_and_grads_match_jax(width):
    """The derived ProtSTonKGs (48 wide: 2 heads of D=24; 144 wide: 4 heads
    of D=36, a width the pair's wrappers pad to 40; block 24 at S=192; cut
    to 1 layer a stack) in training mode at dropout 0: the loss and the
    trunk, projection and head gradients against the JAX package's (XLA
    sparse path), fp32."""
    from stonkgs_tpu.models import protstonkgs as jprot
    from stonkgs_tpu_torch.models import protstonkgs as tprot
    from stonkgs_tpu_torch.models.bigbird import effective_attention_type
    from stonkgs_tpu_torch.utils.convert import bigbird_params_from_jax, \
        protstonkgs_params_from_jax

    tcfg = prot_pretraining_config(_prot_feature_rows(PROT_LAYOUT), width)
    tcfg = tcfg.replace(trunk=dataclasses.replace(tcfg.trunk, **CUT),
                        lm=dataclasses.replace(tcfg.lm, **CUT),
                        prot=dataclasses.replace(tcfg.prot, **CUT))
    assert effective_attention_type(tcfg.trunk, tcfg.seq_len) == "block_sparse"
    assert (tcfg.trunk.block_size, tcfg.trunk.head_dim) == (24, {48: 24, 144: 36}[width])
    d = dataclasses.asdict(tcfg)
    jcfg = jconfig.ProtSTonKGsConfig(**{
        **d, "trunk": jconfig.BigBirdConfig(**d["trunk"]),
        "lm": jconfig.BertConfig(**d["lm"]), "prot": jconfig.BertConfig(**d["prot"])})
    params = _numpy_params(jprot.init_protstonkgs_params, jcfg, seed=0)
    params["kg_backbone"] = np.random.default_rng(1).normal(
        size=(jcfg.kg_table_size, jcfg.trunk.hidden_size)).astype(np.float32)
    rng = np.random.default_rng(width)
    tl, el, pl = PROT_LAYOUT
    n = 2
    batch = {"input_ids": np.concatenate([rng.integers(0, jcfg.lm_vocab_size, (n, tl)),
                                          rng.integers(0, jcfg.kg_table_size, (n, el)),
                                          rng.integers(0, jcfg.prot_vocab_size, (n, pl))], 1),
             "attention_mask": np.ones((n, jcfg.seq_len), np.int64)}
    batch["attention_mask"][1, 150:] = 0       # a pad inside a middle block
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

    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
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
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"grad leaf {i}", **GRAD_TOL)
