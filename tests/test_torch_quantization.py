"""The port's int8 serving mode against the JAX package, on the CPU.

``quantize_params``, the int8 dense's plain version (the CUDA kernel's
counterpart, which a CPU tensor takes) and the quantized models and
engines, against the JAX package's ``ops/quantization.py``, its XLA
``dense_int8`` and its Pallas ``dense_int8_fused`` in interpret mode.
Weights come from the JAX ``init_*`` functions; inputs from a numpy seed.

Tolerances: codes and scales bit-identical (the same IEEE fp32 divisions
and round-half-to-even); the dense in fp32 within 1e-6 of its largest
output (the Pallas interpreter may fuse a multiply-add), in bf16 within
one bf16 step (atol 2e-2, rtol 1e-2); the models in fp32 within 1e-3 and
a cosine of at least 0.9999 per row, because fp32 sums in another order
upstream may move a value across a rounding boundary and flip a code.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import protstonkgs as jprot
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.ops import quantization as jq
from stonkgs_tpu.ops.quantization_pallas import dense_int8_fused as jfused
from stonkgs_tpu_torch import ProtSTonKGsEngine, STonKGsEngine
from stonkgs_tpu_torch.models import protstonkgs as tprot
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.ops import fused_ffn as tffn
from stonkgs_tpu_torch.ops import quantization as tq
from stonkgs_tpu_torch.utils.convert import params_from_jax, params_to, protstonkgs_params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

from test_torch_models import features, port_cfg
from test_torch_protstonkgs import port_cfg as prot_port_cfg

MODEL_ATOL, MIN_COSINE = 1e-3, 0.9999
BF16_TOL = dict(atol=2e-2, rtol=1e-2)

# the STonKGs configuration of tests/test_quantization.py, with a classifier
CFG = jconfig.STonKGsConfig(
    bert=jconfig.BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=128,
                            max_position_embeddings=64),
    kg_vocab_size=150, text_len=16, entity_len=16, num_labels=3)
TCFG = port_cfg(CFG)


def _bert(**kw):
    return jconfig.BertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                              intermediate_size=128, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0, **kw)


# ProtSTonKGs at 2 layers a stack, every width 64 so that every encoder
# dense and the protein projection are quantized; the block-sparse trunk
PCFG = jconfig.ProtSTonKGsConfig(
    trunk=jconfig.BigBirdConfig(
        vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, max_position_embeddings=64, block_size=4, num_random_blocks=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
    lm=_bert(vocab_size=128, max_position_embeddings=8),
    prot=_bert(vocab_size=30, max_position_embeddings=16),
    kg_vocab_size=150, kg_start_idx=12, prot_start_idx=16, seq_len=32,
    sep_id=102, mask_id=103, unk_id=100, num_labels=3)
TPCFG = prot_port_cfg(PCFG)


@pytest.fixture(scope="module")
def tree():
    p = jstonkgs.init_stonkgs_params(jax.random.PRNGKey(0), CFG, with_classifier=True)
    p["kg_backbone"] = 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                               (CFG.kg_table_size, 64))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def prot_tree():
    p = jprot.init_protstonkgs_params(jax.random.PRNGKey(2), PCFG, with_classifier=True)
    p["kg_backbone"] = 0.1 * jax.random.normal(jax.random.PRNGKey(3),
                                               (PCFG.kg_table_size, 64))
    return jax.tree.map(np.asarray, p)


def _jax_quantized(tree):
    return jax.tree.map(np.asarray, jq.quantize_params(tree))


def _named(tree, prefix=""):
    """{"a/b/0/c": leaf} for a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, sub in items:
        out.update(_named(sub, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# quantize_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["stonkgs", "protstonkgs"])
def test_quantize_params_matches_jax(tree, prot_tree, model):
    """The same leaves quantized and skipped; int8 codes identical; scales
    bit-identical; every other leaf unchanged."""
    if model == "stonkgs":
        t, convert, cfg = tree, params_from_jax, TCFG
    else:
        t, convert, cfg = prot_tree, protstonkgs_params_from_jax, TPCFG
    got = _named(tq.quantize_params(convert(t, cfg)))
    want = _named(convert(_jax_quantized(t), cfg))
    assert set(got) == set(want)
    quantized = sorted(k for k in got if k.endswith("kernel_q"))
    assert quantized, "nothing was quantized"
    for k in got:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.int8:
            assert k.endswith("kernel_q")
        assert torch.equal(g, w), k        # bit for bit, scales included
    # skipped: the pooler, embeddings, the KG table, dims below 64
    assert "trunk/pooler/kernel" in got and "trunk/pooler/kernel_q" not in got
    assert got["kg_backbone"].dtype == torch.float32
    assert not any("embeddings" in k and k.endswith("kernel_q") for k in got)
    assert "classifier/kernel" in got            # 64 -> 3
    if model == "stonkgs":
        assert "cls/seq_relationship/kernel" in got   # 64 -> 2
        assert "cls/predictions/entity_decoder/kernel_q" in got
        assert len(quantized) == 2 * 2 * 6 + 1 + 2     # encoders, transform, decoders
    else:
        assert "prot_projection/kernel_q" in got
        assert "cls/predictions/prot_decoder/kernel" in got   # 64 -> 30
        assert len(quantized) == 3 * 2 * 6 + 1 + 1 + 2


def test_quantize_kernel_and_skip_keys():
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32))
    q = tq.quantize_kernel(w)
    j = jq.quantize_kernel(w.numpy())
    assert q["kernel_q"].dtype == torch.int8 and q["scale"].shape == (96,)
    np.testing.assert_array_equal(q["kernel_q"].numpy(), np.asarray(j["kernel_q"]))
    np.testing.assert_array_equal(q["scale"].numpy(), np.asarray(j["scale"]))
    deq = q["kernel_q"].float() * q["scale"]
    assert float((deq - w).abs().max()) < float(w.abs().max()) / 100
    zero = tq.quantize_kernel(torch.zeros(64, 64))   # all-zero columns: scale 1e-12
    assert torch.equal(zero["scale"], torch.full((64,), 1e-12))
    assert not zero["kernel_q"].any()
    tree = {"keep": {"kernel": w, "bias": torch.zeros(96)}, "small": {"kernel": w[:, :8]}}
    out = tq.quantize_params(tree, skip_keys=("keep",))
    assert out["keep"]["kernel"] is w and "kernel_q" in tq.quantize_params(tree)["keep"]
    assert "kernel" in out["small"]
    with pytest.raises(ValueError):
        tq.quantize_kernel(torch.zeros(2, 64, 64))


# ---------------------------------------------------------------------------
# the int8 dense: plain version against the JAX package
# ---------------------------------------------------------------------------

CASES = [
    # (lead, K, N, bias, zero_row): the JAX test's cases (x (2, M/2, K)) ...
    ((2, 32), 128, 256, True, False),
    ((2, 150), 256, 128, True, False),
    ((2, 256), 128, 384, False, False),
    # ... and M = 0, M = 1, an all-zero row, N = 100, 768 -> 3072
    ((0,), 128, 256, True, False),
    ((1,), 768, 768, True, False),
    ((5,), 128, 128, True, True),
    ((7,), 128, 100, True, False),
    ((3, 11), 768, 3072, True, True),
]


def _dense_inputs(lead, K, N, bias, zero_row, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(*lead, K)).astype(np.float32)
    if zero_row:
        x.reshape(-1, K)[1] = 0.0
    b = rng.normal(size=(N,)).astype(np.float32) if bias else None
    return x, w, b


def _jax_codes(x):
    """The activation codes of ``stonkgs_tpu/ops/quantization.py:56-60``."""
    xf = jnp.asarray(x, jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
    return np.asarray(jnp.clip(jnp.round(xf / s), -127, 127).astype(jnp.int8)), np.asarray(s)


@pytest.mark.parametrize("lead,K,N,bias,zero_row", CASES)
def test_dense_int8_plain_matches_jax_fp32(lead, K, N, bias, zero_row):
    x, w, b = _dense_inputs(lead, K, N, bias, zero_row)
    q = jq.quantize_kernel(w)
    jp = {**q, **({"bias": jnp.asarray(b)} if bias else {})}
    want = np.asarray(jq.dense_int8(jnp.asarray(x), jp))
    tp = {"kernel_q": torch.from_numpy(np.array(q["kernel_q"])),
          "scale": torch.from_numpy(np.array(q["scale"]))}
    if bias:
        tp["bias"] = torch.from_numpy(b)
    launches = tq.dense_int8_fused.launches
    got = tq.dense_int8(torch.from_numpy(x), tp)
    assert tq.dense_int8_fused.launches == launches     # CPU: no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (*lead, N)
    codes, scale = tq.quantize_rows(torch.from_numpy(x))
    jcodes, jscale = _jax_codes(x)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(scale.numpy(), jscale)
    limit = 1e-6 * max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=limit, rtol=0)
    if zero_row:   # codes 0: the output is the bias
        np.testing.assert_array_equal(got.reshape(-1, N)[1].numpy(), b)
    if x.size:
        pallas = np.asarray(jfused(jnp.asarray(x), q["kernel_q"], q["scale"],
                                   None if b is None else jnp.asarray(b), interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, atol=limit, rtol=0)


@pytest.mark.parametrize("lead,K,N,bias,zero_row", CASES[:3] + CASES[-2:])
def test_dense_int8_plain_matches_jax_bf16(lead, K, N, bias, zero_row):
    x, w, b = _dense_inputs(lead, K, N, bias, zero_row, seed=1)
    q = jq.quantize_kernel(w)
    jp = {**q, **({"bias": jnp.asarray(b)} if bias else {})}
    want = np.asarray(jq.dense_int8(jnp.asarray(x, jnp.bfloat16), jp), np.float32)
    got = tq.dense_int8_fused(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(np.array(q["kernel_q"])),
                              torch.from_numpy(np.array(q["scale"])),
                              None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_dense_int8_bad_args_and_strided_rows():
    q = tq.quantize_kernel(torch.randn(64, 64))
    # K = 72, no multiple of the kernel's step of 16: the JAX dense's
    # result, as every K (to 1e-6 of the largest output, as the fp32 cases)
    x72, w72, _ = _dense_inputs((2,), 72, 64, False, False, seed=5)
    q72 = jq.quantize_kernel(w72)
    want = np.asarray(jq.dense_int8(jnp.asarray(x72), q72))
    got = tq.dense_int8_fused(torch.from_numpy(x72), torch.from_numpy(np.array(q72["kernel_q"])),
                              torch.from_numpy(np.array(q72["scale"])))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="K >= 1"):
        tq.dense_int8_fused(torch.randn(2, 0), torch.zeros(0, 64, dtype=torch.int8),
                            torch.ones(64))
    with pytest.raises(ValueError, match="int8"):
        tq.dense_int8_fused(torch.randn(2, 64), q["kernel_q"].float(), q["scale"])
    with pytest.raises(ValueError, match="does not match"):
        tq.dense_int8_fused(torch.randn(2, 32), q["kernel_q"], q["scale"])
    with pytest.raises(ValueError, match="bias"):
        tq.dense_int8_fused(torch.randn(2, 64), q["kernel_q"], q["scale"], torch.zeros(3))
    # the [CLS] rows x[:, :1] of a (B, S, H) tensor: a strided view
    x = torch.randn(3, 5, 64)
    got = tq.dense_int8(x[:, :1], q)
    assert torch.equal(got, tq.dense_int8(x[:, :1].contiguous(), q))


@pytest.mark.parametrize("lead,K,N,bias", [((5,), 64, 96, True), ((2, 3), 48, 100, False),
                                          ((4,), 784, 100, True)])
def test_k_major_weight_gives_the_same_dense(lead, K, N, bias):
    """``kernel_q`` relaid column-major (``k_major``, as ``quantized_to``
    stores it on the card): the same shape and values, its transpose read
    as it lies, and the same dense as the row-major weight and as the JAX
    ``dense_int8`` (K % 32 == 16 included); the two launches' plain
    versions, one after the other, give the dense bit for bit."""
    x, w, b = _dense_inputs(lead, K, N, bias, zero_row=False, seed=3)
    q = jq.quantize_kernel(w)
    jp = {**q, **({"bias": jnp.asarray(b)} if bias else {})}
    want = np.asarray(jq.dense_int8(jnp.asarray(x), jp))
    kq = torch.from_numpy(np.array(q["kernel_q"]))
    kcol = tq.k_major(kq)
    assert kcol.shape == kq.shape and kcol.dtype == torch.int8 and torch.equal(kcol, kq)
    assert kcol.t().is_contiguous() and not kcol.is_contiguous()
    assert tq.k_major(kcol).data_ptr() == kcol.data_ptr()          # no second copy
    s = torch.from_numpy(np.array(q["scale"]))
    wt = tq._gemm_operands(kcol, s, None)[0]
    assert wt.data_ptr() == kcol.data_ptr() and wt.is_contiguous()   # read as it lies
    wt_copy = tq._gemm_operands(kq, s, None)[0]
    assert wt_copy.is_contiguous() and torch.equal(wt_copy, kq.t())
    xt = torch.from_numpy(x)
    bt = torch.from_numpy(b) if bias else None
    row, col = tq.dense_int8_fused(xt, kq, s, bt), tq.dense_int8_fused(xt, kcol, s, bt)
    assert torch.equal(row, col)
    limit = 1e-6 * max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(col.numpy(), want, atol=limit, rtol=0)
    codes, scales = tq.dense_int8_quantize(xt)
    M = int(np.prod(lead))
    assert codes.shape == (M, K) and codes.dtype == torch.int8
    assert scales.shape == (M,) and scales.dtype == torch.float32
    jcodes, jscale = _jax_codes(x.reshape(M, K))
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(scales.numpy(), jscale.reshape(-1))
    y = tq.dense_int8_gemm(codes, scales, kcol, s, bt, torch.float32)
    assert torch.equal(y.reshape(*lead, N), row)


# ---------------------------------------------------------------------------
# the quantized models and engines
# ---------------------------------------------------------------------------

@pytest.fixture
def unfused(monkeypatch):
    """Fail on any call of the fused FFN blocks' plain versions, and count
    the int8 dense calls."""
    def boom(*a, **k):
        raise AssertionError("a quantized layer took the fused FFN block")
    monkeypatch.setattr(tffn, "fused_ffn_ln_block_plain", boom)
    monkeypatch.setattr(tffn, "fused_ffn_plain", boom)
    calls = []
    plain = tq.dense_int8_fused_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(tq, "dense_int8_fused_plain", counted)
    return calls


def _check_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= MODEL_ATOL
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert (cos >= MIN_COSINE).all(), cos


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64) for k, v in batch.items()}


def test_stonkgs_int8_pooler_and_logits_match_jax(tree, unfused):
    qtree = _jax_quantized(tree)
    batch = features(CFG, [16, 3, 9, 1], seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = params_from_jax(qtree, TCFG)
    got = tstonkgs.pooler_output(tp, TCFG, _t(batch))
    # backbone 2 layers x 6 denses, trunk 1 full layer x 6 + the [CLS] layer's 6
    assert len(unfused) == 24
    _check_close(got.numpy(), jstonkgs.pooler_output(qtree, CFG, jbatch))
    _check_close(tstonkgs.classification_logits(tp, TCFG, _t(batch)).numpy(),
                 jstonkgs.classification_logits(qtree, CFG, jbatch))
    # the full sequence output of the trunk as well (no cls_only)
    jseq, _ = jstonkgs.trunk_forward(qtree, CFG, **jbatch)
    tseq, _ = tstonkgs.trunk_forward(tp, TCFG, **_t(batch))
    _check_close(tseq.reshape(-1, 64).numpy(), np.asarray(jseq).reshape(-1, 64))


def _prot_features(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, PCFG.lm_vocab_size, (n, PCFG.text_len)),
                          rng.integers(0, PCFG.kg_table_size, (n, PCFG.entity_len)),
                          rng.integers(0, PCFG.prot_vocab_size, (n, PCFG.prot_len))], 1)
    mask = np.ones((n, PCFG.seq_len), np.int64)
    mask[::2, 25:] = 0
    return {"input_ids": ids.astype(np.int64), "attention_mask": mask}


@pytest.mark.parametrize("trunk_type", [None, "original_full"], ids=["sparse", "full"])
def test_protstonkgs_int8_trunk_matches_jax(prot_tree, trunk_type, unfused):
    qtree = _jax_quantized(prot_tree)
    batch = _prot_features(3, seed=1)
    jids, jmask = jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"])
    tp = protstonkgs_params_from_jax(qtree, TPCFG)
    ids, mask = torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"])
    _, got = tprot.trunk_forward(tp, TPCFG, ids, mask, trunk_attention_type=trunk_type,
                                 cls_only=True)
    # LM and protein backbones 2 x 6 each, the projection, trunk 6 + 6
    assert len(unfused) == 37
    _, want = jprot.trunk_forward(qtree, PCFG, jids, jmask, trunk_attention_type=trunk_type,
                                  trunk_attention_impl="xla", cls_only=True)
    _check_close(got.numpy(), want)
    gseq, _ = tprot.trunk_forward(tp, TPCFG, ids, mask, trunk_attention_type=trunk_type)
    wseq, _ = jprot.trunk_forward(qtree, PCFG, jids, jmask, trunk_attention_type=trunk_type,
                                  trunk_attention_impl="xla")
    _check_close(gseq.reshape(-1, 64).numpy(), np.asarray(wseq).reshape(-1, 64))
    _check_close(tprot.classification_logits(tp, TPCFG, {"input_ids": ids,
                                                         "attention_mask": mask}).numpy(),
                 jprot.classification_logits(qtree, PCFG, {"input_ids": jids,
                                                           "attention_mask": jmask}))


def test_engines_serve_quantized_params_on_cpu(tree, prot_tree, unfused):
    """Both engines serve embed and logits with quantized parameters; one
    batch of all the rows gives exactly what the model functions give."""
    tp = tq.quantize_params(params_from_jax(tree, TCFG))
    feats = features(CFG, [16, 3, 9, 1, 12], seed=7)
    eng = STonKGsEngine(cfg=TCFG, params=tp, compute_dtype="float32", batch_size=5,
                        device="cpu")
    np.testing.assert_array_equal(eng.embed(feats),
                                  tstonkgs.pooler_output(tp, TCFG, _t(feats)).numpy())
    np.testing.assert_array_equal(eng.logits(feats),
                                  tstonkgs.classification_logits(tp, TCFG, _t(feats)).numpy())
    # ragged batches of 2: each row as in one batch, up to a flipped code
    _check_close(STonKGsEngine(cfg=TCFG, params=tp, compute_dtype="float32", batch_size=2,
                               device="cpu").embed(feats), eng.embed(feats))

    pp = tq.quantize_params(protstonkgs_params_from_jax(prot_tree, TPCFG))
    pfeats = _prot_features(4, seed=2)
    peng = ProtSTonKGsEngine(cfg=TPCFG, params=pp, compute_dtype="float32", batch_size=4,
                             device="cpu")
    pb = {k: torch.from_numpy(v) for k, v in pfeats.items()}
    np.testing.assert_array_equal(
        peng.embed(pfeats),
        tprot.trunk_forward(pp, TPCFG, pb["input_ids"], pb["attention_mask"],
                            cls_only=True)[1].numpy())
    np.testing.assert_array_equal(peng.logits(pfeats),
                                  tprot.classification_logits(pp, TPCFG, pb).numpy())


def test_bf16_engine_serves_quantized_params(tree):
    """In bf16 (parameters cast by ``params_to``) the int8 engine stays
    within a cosine of 0.99 of its fp32 embeddings."""
    tp = tq.quantize_params(params_from_jax(tree, TCFG))
    feats = features(CFG, [16, 5, 9], seed=9)
    f32 = STonKGsEngine(cfg=TCFG, params=tp, compute_dtype="float32", batch_size=3,
                        device="cpu").embed(feats)
    b16 = STonKGsEngine(cfg=TCFG, params=params_to(tp, "cpu", torch.bfloat16),
                        compute_dtype="bfloat16", batch_size=3, device="cpu").embed(feats)
    cos = (f32 * b16).sum(-1) / (np.linalg.norm(f32, axis=-1) * np.linalg.norm(b16, axis=-1))
    assert (cos >= 0.99).all(), cos


# ---------------------------------------------------------------------------
# convert / params_to
# ---------------------------------------------------------------------------

def test_convert_and_params_to_keep_int8_and_scales(tree):
    qtree = _jax_quantized(tree)
    tp = params_from_jax(qtree, TCFG)
    q = tp["trunk"]["encoder"][0]["attention"]["query"]
    assert q["kernel_q"].dtype == torch.int8 and q["kernel_q"].shape == (64, 64)
    assert q["scale"].dtype == torch.float32 and q["scale"].shape == (64,)
    np.testing.assert_array_equal(q["kernel_q"].numpy(),
                                  qtree["trunk"]["encoder"]["attention"]["query"]["kernel_q"][0])
    b16 = params_to(tp, "cpu", torch.bfloat16)
    named, cast = _named(tp), _named(b16)
    assert set(named) == set(cast)
    for k, t in named.items():
        dense_q = k.rsplit("/", 1)[0] + "/kernel_q" in named
        if t.dtype == torch.int8:
            assert cast[k].dtype == torch.int8 and torch.equal(cast[k], t), k
        elif dense_q:   # scale and bias of a quantized dense stay fp32
            assert cast[k].dtype == torch.float32 and torch.equal(cast[k], t), k
        else:
            assert cast[k].dtype == torch.bfloat16, k
    assert b16["trunk"]["pooler"]["bias"].dtype == torch.bfloat16
    assert any(k.endswith("kernel_q") for k in cast)
    # without a dtype nothing is cast
    assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(params_to(tp, "cpu")),
                                                  tree_leaves(tp)))


def test_params_to_keeps_a_k_major_weight(tree):
    """A tree whose ``kernel_q`` leaves are column-major (as the card holds
    them): ``params_to`` and ``quantized_to`` keep every key, shape, dtype
    and value, and cast nothing of a quantized dense."""
    tp = params_from_jax(_jax_quantized(tree), TCFG)
    col = tree_map(lambda p: {**p, "kernel_q": tq.k_major(p["kernel_q"])}
                   if tq.is_quantized(p) else p, tp, is_leaf=tq.is_quantized)
    moved = params_to(col, "cpu", torch.bfloat16)
    named, got = _named(tp), _named(moved)
    assert set(named) == set(got)
    for k, t in named.items():
        if k.endswith("kernel_q"):
            assert got[k].dtype == torch.int8 and got[k].shape == t.shape, k
            assert torch.equal(got[k], t) and got[k].t().is_contiguous(), k
    one = col["trunk"]["encoder"][0]["attention"]["query"]
    again = tq.quantized_to(one, "cpu")
    assert set(again) == set(one)
    assert all(torch.equal(again[k], one[k]) and again[k].dtype == one[k].dtype for k in one)


def test_tree_map_hands_a_quantized_dense_whole():
    """``params_to`` maps over a tree whose quantized denses are leaves:
    ``tree_map`` with ``is_leaf`` hands such a dense to ``fn`` whole."""
    gen = torch.Generator().manual_seed(0)
    q = tq.quantize_params({"dense": {"kernel": torch.randn(64, 64, generator=gen),
                                      "bias": torch.zeros(64)},
                            "layer_norm": {"scale": torch.ones(64)}})
    seen = []
    tree_map(lambda t: seen.append(t) or t, q, is_leaf=tq.is_quantized)
    assert len(seen) == 2 and tq.is_quantized(seen[0]) and set(seen[0]) == {
        "kernel_q", "scale", "bias"}
    assert torch.is_tensor(seen[1]) and not tq.is_quantized(seen[1])
    moved = tq.quantized_to(seen[0], "cpu")
    assert {k: v.dtype for k, v in moved.items()} == {
        "kernel_q": torch.int8, "scale": torch.float32, "bias": torch.float32}


def test_ffn_half_branches(monkeypatch):
    """``kernel`` FFN leaves take the fused block; quantized ones the
    unfused order through two int8 denses, whose result stays close to
    the fused one (int8 weights and activations: cosine > 0.99)."""
    from stonkgs_tpu_torch.models import bert as tbert

    gen = torch.Generator().manual_seed(0)
    lp = tbert.init_layer_params(gen, TCFG.bert)
    x, a = torch.randn(2, 5, 64, generator=gen), torch.randn(2, 5, 64, generator=gen)
    fused = tbert.ffn_half(x, a, lp, TCFG.bert, True, None)
    q = tq.quantize_params(lp)
    assert "kernel_q" in q["intermediate"] and "kernel_q" in q["output"]
    monkeypatch.setattr(tffn, "fused_ffn_ln_block_plain", None)   # must not be called
    got = tbert.ffn_half(x, a, q, TCFG.bert, True, None)
    assert got.shape == fused.shape and bool(torch.isfinite(got).all())
    cos = torch.nn.functional.cosine_similarity(got.reshape(-1, 64), fused.reshape(-1, 64),
                                                dim=-1)
    assert bool((cos > 0.99).all()), cos
