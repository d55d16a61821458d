"""The port's training ops against the JAX package, on the CPU.

On a CPU tensor each training wrapper runs its kernel's plain PyTorch
version; these tests hold it, forward and gradients, against the JAX
package's Pallas kernels in interpret mode, and the losses and optimizer
against their JAX counterparts.  Inputs come from numpy seeds.

Tolerances: fp32 atol 2e-5 / rtol 1e-4 for attention and 1e-5 / 1e-4 for
the FFN (sums in another order; the JAX FFN kernel's Abramowitz-Stegun
erf is off by < 1.5e-7).  With dropout at rate 0.25 the fp32 tolerance
still holds, which is only possible when the hash masks agree bit for
bit.  bf16 atol and rtol 2e-2 (attention) or 5e-2 (the FFN gradients,
which are sums over rows of products of rounded operands): the two
frameworks may round an intermediate to the other neighbour.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu.ops import flash_attention as jflash
from stonkgs_tpu.ops import fused_ffn as jffn
from stonkgs_tpu.ops import losses as jlosses
from stonkgs_tpu.train.optimizer import make_optimizer
from stonkgs_tpu_torch.ops import flash_attention as tflash
from stonkgs_tpu_torch.ops import fused_ffn as tffn
from stonkgs_tpu_torch.ops import losses as tlosses
from stonkgs_tpu_torch.train import optimizer as topt

ATTN_TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
FFN_TOL = {"float32": dict(atol=1e-5, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
SEED_WORDS = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# flash_attention_train
# ---------------------------------------------------------------------------

def _attn_arrays(S, B=2, H=3, D=16, seed=0):
    rng = np.random.default_rng(100 + S)
    q, k, v, w = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(4))
    keep = rng.random((B, S)) > 0.2
    keep[:, :1] = True   # every row has a key to attend to
    bias = ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, w


def _jax_attention(arrays, dtype, rate, block_q=32):
    q, k, v, bias, w = arrays
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))

    def loss(q, k, v, b):
        out = jflash.flash_attention_train(
            q, k, v, b, dropout_rate=rate, dropout_rng=jnp.asarray(SEED_WORDS),
            block_q=block_q, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jq, jk, jv, jnp.asarray(bias))
    return out, grads


def _torch_attention(arrays, dtype, rate, block_q=32):
    q, k, v, bias, w = arrays
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
                  for a in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_(True)
    seed = torch.from_numpy(SEED_WORDS.view(np.int32))
    out = tflash.flash_attention_train(tq, tk, tv, tb, dropout_rate=rate, seed=seed,
                                       block_q=block_q)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, (tq.grad, tk.grad, tv.grad, tb.grad)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# 40 pads to S_pad = 64 at block_q 32; 65 and 129 sit one past the card's
# 64- and 128-row tiles (S_pad 96 and 160); 300 (one row, one head, to
# keep interpret mode quick) pads to S_pad = 512 at the default block_q 256
@pytest.mark.parametrize("S", [1, 40, 64, 65, 129, 300])
def test_flash_attention_train_matches_pallas_kernel(S, dtype, rate):
    B, H, block_q = (1, 1, 256) if S == 300 else (2, 3, 32)
    arrays = _attn_arrays(S, B, H)
    want_out, want_grads = _jax_attention(arrays, dtype, rate, block_q)
    launches = (tflash.flash_attention_train_fwd.launches,
                tflash.flash_attention_train_bwd.launches)
    got_out, got_grads = _torch_attention(arrays, dtype, rate, block_q)
    assert (tflash.flash_attention_train_fwd.launches,
            tflash.flash_attention_train_bwd.launches) == launches  # CPU: no kernel
    assert got_out.dtype == getattr(torch, dtype)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(got_out), _np(want_out), **tol)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got_grads, want_grads):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **tol)


def test_dropout_hash_keeps_its_rate_and_depends_on_the_seed():
    idx = torch.arange(64)
    a = tflash.dropout_keep_plain((1, 2), 2, 3, 64, idx, idx, 0.25)
    b = tflash.dropout_keep_plain((1, 3), 2, 3, 64, idx, idx, 0.25)
    assert a.shape == (2, 3, 64, 64) and a.dtype == torch.bool
    assert abs(a.float().mean().item() - 0.75) < 0.01
    assert (a != b).float().mean().item() > 0.3
    # the index is the padded grid's: other S_pad, other mask
    c = tflash.dropout_keep_plain((1, 2), 2, 3, 128, idx, idx, 0.25)
    assert not torch.equal(a, c)


def test_padded_length_follows_the_tpu_kernel():
    assert tflash.padded_length(1) == 1
    assert tflash.padded_length(260) == 512       # TransE: 256 + 4
    assert tflash.padded_length(512) == 512
    assert tflash.padded_length(40, 32) == 64
    assert tflash.padded_length(4096) == 4096     # block 128 past S = 1024
    assert tflash.padded_length(1100) == 1152
    assert tflash.dropout_threshold(0.1) == 3865470566
    assert tflash.dropout_threshold(0.0) == 2 ** 32 - 1


def test_flash_attention_train_without_seed_or_bias():
    """No seed: no dropout (as the JAX package without an rng); no bias:
    gradients for q, k, v only."""
    q, k, v, _, _ = _attn_arrays(40)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tflash.flash_attention_train(tq, tk, tv, None, dropout_rate=0.5, seed=None)
    want = jflash.flash_attention_train(*(jnp.asarray(a) for a in (q, k, v)), None,
                                        block_q=32, interpret=True)
    np.testing.assert_allclose(_np(out), _np(want), **ATTN_TOL["float32"])
    out.square().sum().backward()
    assert all(t.grad is not None for t in (tq, tk, tv))
    with pytest.raises(ValueError, match="rate"):
        tflash.flash_attention_train_fwd(tq, tk, tv, None, (0, 0), 1.0)


# ---------------------------------------------------------------------------
# fused_ffn
# ---------------------------------------------------------------------------

def _ffn_arrays(M, H=64, I=128):
    rng = np.random.default_rng(200 + M)
    f = np.float32
    return [(rng.normal(size=(M, H)) * 0.5).astype(f),
            (rng.normal(size=(H, I)) * 0.1).astype(f), (rng.normal(size=I) * 0.1).astype(f),
            (rng.normal(size=(I, H)) * 0.1).astype(f), (rng.normal(size=H) * 0.1).astype(f),
            rng.normal(size=(M, H)).astype(f)]


@pytest.mark.parametrize("H,I", [(64, 128), (128, 320)], ids=["H64", "H128-I320"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
@pytest.mark.parametrize("M", [0, 3, 37])
def test_fused_ffn_matches_pallas_kernels(H, I, M, act, dtype, monkeypatch):
    """Forward output and all five gradients, at two widths: I = 320 is
    not a multiple of the Hopper kernels' 128-column tiles.  JAX's kernels
    divide by zero at M = 0, so there the port is held against the JAX
    package's unfused chain."""
    x, w1, b1, w2, b2, w = _ffn_arrays(M, H, I)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    monkeypatch.setattr(jffn, "BWD_IMPL", "kernel")
    if M:
        fn = lambda *a: jffn.fused_ffn(*a, act=act, block_m=16, interpret=True)  # noqa: E731
    else:
        fn = lambda *a: jffn._ffn_reference(*a, act=act)  # noqa: E731
    jargs = [jnp.asarray(x, jdt)] + [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    want_out, vjp = jax.vjp(fn, *jargs)
    want_grads = vjp(jnp.asarray(w, jdt))

    targs = [torch.from_numpy(x).to(tdt)] + [torch.from_numpy(a) for a in (w1, b1, w2, b2)]
    for t in targs:
        t.requires_grad_(True)
    launches = (tffn.fused_ffn_fwd.launches, tffn.fused_ffn_bwd.launches)
    got_out = tffn.fused_ffn(*targs, act=act)
    got_out.backward(torch.from_numpy(w).to(tdt))
    assert (tffn.fused_ffn_fwd.launches, tffn.fused_ffn_bwd.launches) == launches
    assert got_out.dtype == tdt and got_out.shape == (M, H)
    tol = FFN_TOL[dtype]
    np.testing.assert_allclose(_np(got_out), _np(want_out), **tol)
    for name, t, want in zip(("x", "w1", "b1", "w2", "b2"), targs, want_grads):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(_np(t.grad), _np(want), err_msg=name, **tol)


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_gelu_grad_matches_autograd(act):
    """gelu' of the plain backward (which the Hopper kernel's epilogue
    mirrors) is the derivative of its gelu, in fp32 over [-6, 6]."""
    h = torch.linspace(-6.0, 6.0, 24001, dtype=torch.float32, requires_grad=True)
    (want,) = torch.autograd.grad(tffn._gelu(h, act).sum(), h)
    a, got = tffn._gelu_and_grad(h.detach(), act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(a.numpy(), tffn._gelu(h.detach(), act).numpy())


def test_fused_ffn_3d_input_and_bad_args():
    x, w1, b1, w2, b2, _ = (torch.from_numpy(a) for a in _ffn_arrays(12))
    flat = tffn.fused_ffn(x, w1, b1, w2, b2)
    np.testing.assert_array_equal(
        tffn.fused_ffn(x.reshape(3, 4, 64), w1, b1, w2, b2).reshape(12, 64).numpy(),
        flat.numpy())
    with pytest.raises(ValueError, match="activation"):
        tffn.fused_ffn(x, w1, b1, w2, b2, act="relu")
    with pytest.raises(ValueError, match="device"):
        tffn.fused_ffn_fwd(*(t.to("meta") for t in (x, w1, b1, w2, b2)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mixed", "all_ignored", "nsp"])
def test_masked_cross_entropy_matches_jax(case):
    """Gathered (B, K, V) logits with ignored slots, an all-ignored batch
    (0, not NaN), and (B, 2) NSP logits."""
    rng = np.random.default_rng(7)
    shape = (6,) if case == "nsp" else (3, 5)
    vocab = 2 if case == "nsp" else 11
    logits = rng.normal(size=shape + (vocab,)).astype(np.float32)
    labels = rng.integers(0, vocab, shape)
    if case != "nsp":
        labels[rng.random(shape) < 0.4] = -100
    if case == "all_ignored":
        labels[:] = -100
    want = jlosses.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tlosses.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    if case == "all_ignored":
        assert got.item() == 0.0


@pytest.mark.parametrize("k", [2, 4, 7])
def test_gather_masked_positions_matches_top_k_ties(k):
    """More slots than masked positions in some rows: the unmasked tail is
    taken lowest index first, as jax.lax.top_k breaks ties."""
    rng = np.random.default_rng(8)
    hidden = rng.normal(size=(4, 9, 6)).astype(np.float32)
    labels = np.full((4, 9), -100)
    for i, n in enumerate((0, 2, 4, 9)):
        labels[i, rng.choice(9, n, replace=False)] = rng.integers(0, 50, n)
    want = jlosses.gather_masked_positions(jnp.asarray(hidden), jnp.asarray(labels), k)
    got = tlosses.gather_masked_positions(torch.from_numpy(hidden),
                                          torch.from_numpy(labels), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay,warmup", [(0.0, 0), (0.01, 2)])
def test_adamw_matches_optax_chain(weight_decay, warmup):
    """Three steps with the clip active (global norm >> 1), against the
    optax chain of make_optimizer; fp32, atol 1e-6 (one step moves a
    parameter by about lr = 1e-2)."""
    rng = np.random.default_rng(9)
    shapes = {"w": (4, 3), "b": (3,), "nested": [{"k": (2, 5)}]}
    as_np = lambda f: {"w": f(shapes["w"]), "b": f(shapes["b"]),  # noqa: E731
                       "nested": [{"k": f(shapes["nested"][0]["k"])}]}
    params = as_np(lambda s: rng.normal(size=s).astype(np.float32))
    grads = [as_np(lambda s: (30.0 * rng.normal(size=s)).astype(np.float32))
             for _ in range(3)]
    tx = make_optimizer(None, learning_rate=1e-2, total_steps=5, warmup_steps=warmup,
                        weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    ours = topt.AdamW(learning_rate=1e-2, total_steps=5, warmup_steps=warmup,
                      weight_decay=weight_decay)
    tp = {"w": torch.from_numpy(params["w"]), "b": torch.from_numpy(params["b"]),
          "nested": [{"k": torch.from_numpy(params["nested"][0]["k"])}]}
    tstate = ours.init(tp)
    leaves = [tp["w"], tp["b"], tp["nested"][0]["k"]]
    for g in grads:
        ours.update_and_apply([torch.from_numpy(g["w"]), torch.from_numpy(g["b"]),
                               torch.from_numpy(g["nested"][0]["k"])], tstate, leaves)
    assert tstate["count"] == 3
    for got, want in zip(leaves, (jp["w"], jp["b"], jp["nested"][0]["k"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_schedule_and_frozen_split():
    sched = topt.linear_schedule(1.0, 10, warmup_steps=2)
    assert [sched(c) for c in (0, 1, 2, 6, 10, 12)] == [0.0, 0.5, 1.0, 0.5, 0.0, 0.0]
    params = {"trunk": 1, "cls": 2, "lm_backbone": 3, "kg_backbone": 4}
    train, frozen = topt.split_frozen(params)
    assert set(train) == {"trunk", "cls"} and set(frozen) == {"lm_backbone", "kg_backbone"}
    assert topt.merge_frozen(train, frozen) == params
