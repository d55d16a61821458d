"""The port at the widths the JAX package runs past the earlier domains,
against the JAX package, on the CPU.

The JAX package runs every width: it sends a shape to its Pallas kernels
where they fit and to XLA elsewhere.  The card's kernels now take the FFN
at any H and I from 8 (H = 2,056 and 2,560 here, I = 4H), attention at any
D from 8 to 256 (136 and 256 here) and the int8 dense at any K (72 and
100 here: no multiple of the kernel's step of 16).  On a CPU tensor each
wrapper runs its kernel's plain version, which these tests hold against
the JAX function at the same width: the Pallas kernel in interpret mode
where the JAX package's wrapper takes it there, else the XLA path it
falls back to.  Then the int8 engine at the 100-wide config the command
line derives (K = 100) against the JAX package's quantized engine, and
STonKGs at 2560 wide (40 heads of 64, I = 10,240) and at BERT-base's
widths in 3 heads of 256, 1 layer a stack, against the JAX models
through ``params_from_jax``.  The kernels themselves are held against the
plain versions on the card by ``chip_smoke.py`` phases 16 and 29.  Inputs
come from numpy seeds.

Tolerances, fp32, as ``tests/test_torch_widths.py``: the FFN atol 1e-5 /
rtol 1e-4 and its gradients within 1e-5 of their largest magnitude (or
of 1); attention atol 1e-5 / rtol 1e-4 (with the hash dropout at rate
0.1, which is only possible when both masks agree bit for bit), its
gradients, sums over rows (and heads for the bias) of up to 256-wide
products, within 1e-5 of their largest magnitude (or of 1); the int8
dense within 1e-6 of its largest output (the same codes and epilogue;
sums in another order), in bf16 within one bf16 step (atol 2e-2, rtol
1e-2); the int8 engine within 1e-3 and a cosine of 0.9999 a row (a code
may flip where fp32 sums upstream straddle a rounding boundary); the
models' outputs atol 1e-4 / rtol 1e-4 and the losses rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.api.inference import STonKGsEngine as JaxEngine
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.ops import flash_attention as jflash
from stonkgs_tpu.ops import fused_ffn as jffn
from stonkgs_tpu.ops import quantization as jq
from stonkgs_tpu_torch import STonKGsEngine
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.ops import flash_attention as tflash
from stonkgs_tpu_torch.ops import fused_ffn as tffn
from stonkgs_tpu_torch.ops import quantization as tq
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import params_from_jax
from test_torch_ffn_widths import _ffn_arrays
from test_torch_head_widths import SEED_WORDS, _attn_arrays, _features, _np, port_cfg

FFN_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_SCALE_TOL = 1e-5
ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
INT8_F32_TOL = 1e-6
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
ENGINE_ATOL, MIN_COSINE = 1e-3, 0.9999
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


# ---------------------------------------------------------------------------
# the FFN kernels' plain versions past H = 2048
# ---------------------------------------------------------------------------

FFN_WIDTHS = [2056, 2560]
FFN_ROWS = 3


@pytest.mark.parametrize("H", FFN_WIDTHS)
def test_fused_ffn_ln_block_matches_jax(H):
    """The serving block's plain version against the JAX block."""
    a = _ffn_arrays(FFN_ROWS, H, 4 * H)[:10]
    want = jffn.fused_ffn_ln_block(*(jnp.asarray(x) for x in a), act="gelu", eps=1e-12,
                                   block_m=32, interpret=True)
    got = tffn.fused_ffn_ln_block(*(torch.from_numpy(x) for x in a), act="gelu", eps=1e-12)
    np.testing.assert_allclose(_np(got), _np(want), **FFN_TOL)


@pytest.mark.parametrize("H", FFN_WIDTHS)
def test_fused_ffn_and_its_gradients_match_jax(H, monkeypatch):
    """The training forward and the backward's five gradients against the
    JAX custom VJP, its backward asked for the kernel (the package takes
    XLA where the kernel does not fit)."""
    a = _ffn_arrays(FFN_ROWS, H, 4 * H)
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


@pytest.mark.parametrize("H,dtype,Hp", [(2056, torch.bfloat16, 2056),
                                        (2056, torch.float32, 2080),
                                        (2560, torch.float32, 2560)])
def test_scratch_of_the_split_fp32_path(H, dtype, Hp):
    """The wrappers' scratch: bf16 always takes x2 and h, fp32 only above
    a padded H of 2048 (the split path), at the padded widths."""
    assert tffn.padded_width(H, dtype) == Hp
    Ip = tffn.padded_width(4 * H, dtype)
    x2, h = tffn._scratch(5, Hp, Ip, dtype, "cpu", True)
    assert x2.shape == (5, Hp) and h.shape == (5, Ip) and h.dtype == dtype
    assert tffn._scratch(5, Hp, Ip, dtype, "cpu", False)[0] is None
    assert tffn._scratch(5, 2048, 8192, torch.float32, "cpu", True) == (None, None)


# ---------------------------------------------------------------------------
# the attention kernels' plain versions at D = 136 and 256
# ---------------------------------------------------------------------------

HEAD_DIMS = [136, 256]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 65])
def test_flash_attention_infer_matches_jax(S, D):
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
    tq_, tk, tv, tb = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias))
    got = tflash.flash_attention_train(tq_, tk, tv, tb, dropout_rate=rate,
                                       seed=torch.from_numpy(SEED_WORDS.view(np.int32)),
                                       block_q=32)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)
    for name, g, wg in zip(("dq", "dk", "dv", "dbias"), (tq_.grad, tk.grad, tv.grad, tb.grad),
                           want_grads):
        want_g = _np(wg)
        np.testing.assert_allclose(_np(g), want_g, err_msg=name, rtol=0.0,
                                   atol=GRAD_SCALE_TOL * max(1.0, float(np.abs(want_g).max())))


# ---------------------------------------------------------------------------
# the int8 dense at K = 72 and 100
# ---------------------------------------------------------------------------

def _int8_arrays(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[1] = 0.0   # an all-zero row: scale 1e-12, every code 0
    return (x, rng.normal(size=(K, N)).astype(np.float32),
            rng.normal(size=(N,)).astype(np.float32))


@pytest.mark.parametrize("K", [72, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_int8_matches_jax_at_any_k(K, dtype):
    """The plain dense (codes, the exact int32 product, the epilogue) and
    the codes and scales of its row pass, against the JAX ``dense_int8``
    (its Pallas kernel takes K a multiple of 128; the package runs XLA
    there), and the weight in the card's K-major layout: rows of Kp =
    padded_k(K) codes whose padding is zero, the same values."""
    x, w, b = _int8_arrays(7, K, 96, seed=K)
    q = jq.quantize_kernel(w)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jq.dense_int8(jnp.asarray(x, jdt), {**q, "bias": jnp.asarray(b)}),
                      np.float32)
    kq = torch.from_numpy(np.array(q["kernel_q"]))
    kcol = tq.k_major(kq)
    Kp = tq.padded_k(K)
    assert Kp % tq.K_MULTIPLE == 0 and K <= Kp < K + tq.K_MULTIPLE
    assert torch.equal(kcol, kq) and tq.is_k_major(kcol) and kcol.stride() == (1, Kp)
    assert not torch.as_strided(kcol, (kq.shape[1], Kp), (Kp, 1))[:, K:].any()
    for weight in (kq, kcol):
        got = tq.dense_int8(torch.from_numpy(x).to(tdt),
                            {"kernel_q": weight, "scale": torch.from_numpy(np.array(q["scale"])),
                             "bias": torch.from_numpy(b)})
        assert got.dtype == tdt and got.shape == (7, 96)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=INT8_F32_TOL * np.abs(want).max())
        else:
            np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    codes, scales = tq.dense_int8_quantize(torch.from_numpy(x))
    xf = jnp.asarray(x)
    js = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
    jcodes = jnp.clip(jnp.round(xf / js), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js)[:, 0])


# ---------------------------------------------------------------------------
# the int8 engine at the command line's 100-wide config
# ---------------------------------------------------------------------------

# what ``stonkgs_pretraining_config`` derives from 100-wide KG vectors (2
# layers, 2 heads of 50, I = 400), at 16 + 16 tokens and a vocabulary of
# 1,024: every encoder dense (K = 100 or 400) is quantized
CFG100 = jconfig.STonKGsConfig(
    bert=jconfig.BertConfig(vocab_size=1024, hidden_size=100, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=400,
                            max_position_embeddings=64, **NO_DROPOUT),
    kg_vocab_size=101, text_len=16, entity_len=16)


def test_int8_engine_at_100_wide_matches_jax_engine():
    """``quantize_params`` -> ``STonKGsEngine.embed`` (fp32, the int8 dense
    at K = 100 and 400) against the JAX package's engine over its own
    ``quantize_params``: the same codes and scales, the embeddings within
    1e-3 and a cosine of 0.9999 a row."""
    tree = _numpy_params(CFG100, seed=3)
    tcfg = port_cfg(CFG100)
    jtree = jax.tree.map(np.asarray, jq.quantize_params(tree))
    tp = tq.quantize_params(params_from_jax(tree, tcfg))
    layer = tp["trunk"]["encoder"][0]
    jlayer = params_from_jax(jtree, tcfg)["trunk"]["encoder"][0]
    for dense, jdense, K in ((layer["attention"]["query"], jlayer["attention"]["query"], 100),
                             (layer["intermediate"], jlayer["intermediate"], 100),
                             (layer["output"], jlayer["output"], 400)):
        assert tq.is_quantized(dense) and dense["kernel_q"].shape[0] == K
        np.testing.assert_array_equal(dense["kernel_q"].numpy(), jdense["kernel_q"].numpy())
        np.testing.assert_array_equal(dense["scale"].numpy(), jdense["scale"].numpy())
    feats = {k: v for k, v in _features(CFG100, 5, seed=4).items()
             if k in ("input_ids", "attention_mask", "token_type_ids")}
    want = JaxEngine(cfg=CFG100, params=jtree, compute_dtype="float32",
                     batch_size=5).embed(feats)
    got = STonKGsEngine(cfg=tcfg, params=tp, compute_dtype="float32", batch_size=5,
                        device="cpu").embed(feats)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape == (5, 100)
    assert np.abs(got - want).max() <= ENGINE_ATOL
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert (cos >= MIN_COSINE).all(), cos


# ---------------------------------------------------------------------------
# STonKGs at 2560 wide and at BERT-base's widths in 3 heads of 256
# ---------------------------------------------------------------------------

# the command line's 2560-wide config (40 heads of 64, I = 10,240) and
# BERT-base's widths in 3 heads of 256, each at 1 layer a stack, 16 + 16
# tokens and a vocabulary of 1,024
CFG2560 = jconfig.STonKGsConfig(
    bert=jconfig.BertConfig(vocab_size=1024, hidden_size=2560, num_hidden_layers=1,
                            num_attention_heads=40, intermediate_size=10240,
                            max_position_embeddings=64, **NO_DROPOUT),
    kg_vocab_size=101, text_len=16, entity_len=16)
CFG3 = jconfig.STonKGsConfig(
    bert=jconfig.BertConfig(vocab_size=1024, num_hidden_layers=1, num_attention_heads=3,
                            max_position_embeddings=64, **NO_DROPOUT),
    kg_vocab_size=101, text_len=16, entity_len=16)


def _numpy_params(cfg, seed=0):
    """STonKGs parameters in the JAX package's layout, drawn with numpy
    (weights and biases at std 0.02, LayerNorm scales at 1 + 0.1 N(0, 1))
    with a random KG table: the JAX initialiser's eager draws take
    seconds at 2560 wide."""
    shapes = jax.eval_shape(lambda k: jstonkgs.init_stonkgs_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape, dtype=np.float32)
        return 1.0 + 0.1 * v if "scale" in str(path[-1]) else 0.02 * v

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    params["kg_backbone"] = rng.standard_normal((cfg.kg_table_size, cfg.bert.hidden_size),
                                                dtype=np.float32)
    return params


@pytest.mark.parametrize("cfg", [CFG2560, CFG3], ids=["H2560", "3x256"])
def test_pooled_output_and_loss_match_jax(cfg):
    """The pooled output and the deterministic pre-training loss and its
    parts, through the kernels' plain versions at H = 2560 (the FFN past
    2048) and at D = 256."""
    tcfg = port_cfg(cfg)
    assert tffn.ffn_kernel_takes(tcfg.bert.hidden_size, tcfg.bert.intermediate_size)
    assert tflash.attention_kernel_takes(tcfg.bert.head_dim)
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

