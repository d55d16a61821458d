"""The port's BigBird pieces against the JAX package at fp32, on the CPU.

* the random-block plan, exactly (HF's np.random stream replayed);
* ``block_sparse_attention`` (its CPU path: the kernels' plain versions)
  against the JAX XLA lowering and against the Pallas kernel in interpret
  mode, forward and q/k/v gradients, as ``tests/test_bigbird_sparse_pallas.py``
  holds the two JAX versions: forwards within 1e-5 absolute, gradients
  within 2e-5 absolute + 1e-4 relative (both frameworks sum in fp32, in
  another order); at block 16 and at the kernels' block 128 (S=1280);
* ``bigbird_model`` in block-sparse mode, in ``original_full`` mode and
  with ``cls_only``, within 1e-5 absolute (inputs made with a numpy seed,
  weights from the JAX ``init_bigbird_params``), and in block-sparse mode
  at ``block_size=128`` (S=1024);
* host-side pieces of the Hopper kernels and their yardstick: the tensor
  map each (B, S, H, D) view gets, and SDPA over gathered operands
  (``benchmarks/bigbird_sdpa.py``) against the plain forward at fp32
  within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import bigbird as jbigbird
from stonkgs_tpu.ops import bigbird_sparse as jsparse
from stonkgs_tpu.ops.bigbird_sparse_pallas import block_sparse_attention_pallas
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.benchmarks import bigbird_sdpa
from stonkgs_tpu_torch.models import bigbird as tbigbird
from stonkgs_tpu_torch.ops import bigbird_sparse as tsparse
from stonkgs_tpu_torch.utils.convert import bigbird_params_from_jax

FWD_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
B, H, D, BS = 2, 3, 8, 16


@pytest.mark.parametrize("seq_len,bs,r,heads,max_len,training", [
    (4096, 64, 3, 12, 4096, True),    # the trunk: HF's fixed plan, last_idx 1024
    (3072, 64, 3, 4, 4096, True),
    (768, 64, 3, 4, 4096, True),      # a non-special length: the per-head plan
    (48, 4, 1, 2, 48, True),
    (4096, 64, 3, 12, 4096, False),   # eval: all zeros
    (4096, 128, 3, 12, 4096, True),   # the trunk at block 128
    (1280, 128, 2, 4, 1280, True),    # block 128, the per-head plan
    (4096, 128, 3, 12, 4096, False),
], ids=["4096", "3072", "768", "48", "eval", "4096-bs128", "1280-bs128", "eval-bs128"])
def test_rand_attn_matches_jax(seq_len, bs, r, heads, max_len, training):
    state = np.random.get_state()
    want = jsparse.build_rand_attn(seq_len, bs, r, heads, 3, max_len, training)
    np.random.set_state(state)
    got = tsparse.build_rand_attn(seq_len, bs, r, heads, 3, max_len, training)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the port leaves the global stream alone
    assert np.random.get_state()[1][0] == state[1][0]


def _inputs(nb, r, seed, padded, zero_plan, bs=BS, heads=H, d=D):
    rng = np.random.default_rng(seed)
    S = nb * bs
    q, k, v = (rng.normal(size=(B, heads, S, d)).astype(np.float32) * 0.5 for _ in range(3))
    mask = np.ones((B, S), np.float32)
    if padded:
        mask[0, -(bs + 4):] = 0.0           # pad crossing the last block boundary
        mask[1, 2 * bs + 5:2 * bs + 13] = 0.0  # pad inside a middle block
    if zero_plan:
        rand = np.zeros((heads, nb - 2, r), np.int32)
    else:
        rand = rng.integers(1, nb - 1, (heads, nb - 2, r)).astype(np.int32)
    w = rng.normal(size=(B, heads, S, d)).astype(np.float32)
    return q, k, v, rand, mask, w


# (block size, heads, nb, r, padded, zero plan): block 16 over three
# geometries, and the kernels' block 128 at S=1280 (nb=10, r=2, H=2)
CASES = [(BS, H, nb, r, padded, zero) for nb, r in ((5, 1), (6, 3), (8, 2))
         for padded in (True, False) for zero in (True, False)]
CASES += [(128, 2, 10, 2, True, zero) for zero in (False, True)]
IDS = [f"{'' if bs == BS else f'bs{bs}-'}nb{nb}-r{r}-{'pad' if p else 'full'}-"
       f"{'zero' if z else 'rand'}" for bs, _, nb, r, p, z in CASES]
GRAD_CASES = CASES[:12:2] + CASES[12:]


@pytest.mark.parametrize("bs,heads,nb,r,padded,zero_plan", CASES, ids=IDS)
def test_block_sparse_forward_matches_jax(bs, heads, nb, r, padded, zero_plan):
    q, k, v, rand, mask, _ = _inputs(nb, r, nb * 10 + r, padded, zero_plan, bs, heads)
    jargs = [jnp.asarray(a) for a in (q, k, v, rand, mask)]
    xla = np.asarray(jsparse.block_sparse_attention(*jargs, bs))
    pallas = np.asarray(block_sparse_attention_pallas(*jargs, bs, interpret=True))
    got = tsparse.block_sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)), rand,
                                         torch.from_numpy(mask), bs).numpy()
    np.testing.assert_allclose(got, xla, **FWD_TOL)
    np.testing.assert_allclose(got, pallas, **FWD_TOL)


@pytest.mark.parametrize("bs,heads,nb,r,padded,zero_plan", GRAD_CASES,
                         ids=IDS[:12:2] + IDS[12:])
def test_block_sparse_gradients_match_jax(bs, heads, nb, r, padded, zero_plan):
    """q/k/v cotangents of the port's autograd Function against JAX
    autodiff through the XLA lowering and the Pallas custom VJP."""
    q, k, v, rand, mask, w = _inputs(nb, r, nb * 10 + r + 1, padded, zero_plan, bs, heads)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jr, jm, jw = jnp.asarray(rand), jnp.asarray(mask), jnp.asarray(w)
    xla = jax.grad(lambda *a: jnp.sum(jsparse.block_sparse_attention(*a, jr, jm, bs) * jw),
                   argnums=(0, 1, 2))(jq, jk, jv)
    pallas = jax.grad(
        lambda *a: jnp.sum(block_sparse_attention_pallas(*a, jr, jm, bs, interpret=True) * jw),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tsparse.block_sparse_attention(tq, tk, tv, rand, torch.from_numpy(mask), bs)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, a, b in zip("qkv", (tq, tk, tv), xla, pallas):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(a), err_msg=f"d{name} xla",
                                   **GRAD_TOL)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(b), err_msg=f"d{name} pallas",
                                   **GRAD_TOL)


# the kernels' new domain: head widths 16 and 32 at block sizes the
# command line derives (S // 8: 8 at S=64 ... 512 at S=4096), partial 64-row
# tiles included (8, 48, 96), with 2 heads, nb=5 or 6 and r=1 or 2
WIDTH_CASES = [(bs, d, 5 + i % 2, 1 + i % 2) for i, bs in enumerate((8, 48, 96, 256, 512))
               for d in (16, 32)]
WIDTH_IDS = [f"bs{bs}-D{d}-nb{nb}-r{r}" for bs, d, nb, r in WIDTH_CASES]


@pytest.mark.parametrize("bs,d,nb,r", WIDTH_CASES, ids=WIDTH_IDS)
def test_block_sparse_at_new_widths_matches_jax(bs, d, nb, r):
    """``block_sparse_attention`` (the plain pair on the CPU) at D = 16 and
    32 and block sizes that are not 64 or 128, with a padded mask and a
    random plan: the forward and the q, k, v gradients against the JAX
    XLA lowering and the Pallas kernel in interpret mode (under
    ``jax.jit``), with the block-16 tolerances."""
    q, k, v, rand, mask, w = _inputs(nb, r, bs + d, True, False, bs, 2, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jr, jm, jw = jnp.asarray(rand), jnp.asarray(mask), jnp.asarray(w)

    def xla(*a):
        return jsparse.block_sparse_attention(*a, jr, jm, bs)

    def pallas(*a):
        return block_sparse_attention_pallas(*a, jr, jm, bs, interpret=True)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tsparse.block_sparse_attention(tq, tk, tv, rand, torch.from_numpy(mask), bs)
    (out * torch.from_numpy(w)).sum().backward()
    for name, fn in (("xla", xla), ("pallas", pallas)):
        want = np.asarray(jax.jit(fn)(jq, jk, jv))
        np.testing.assert_allclose(out.detach().numpy(), want, err_msg=name, **FWD_TOL)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * jw), argnums=(0, 1, 2)))(jq, jk, jv)
        for n_, got, g in zip("qkv", (tq, tk, tv), grads):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(g), err_msg=f"d{n_} {name}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("bs,d", [(48, 32), (96, 16), (512, 32)], ids=["bs48-D32", "bs96-D16",
                                                                      "bs512-D32"])
def test_mid_blocks_plain_at_new_widths(bs, d):
    """The plain pair at a partial or large block: shapes, the lse equal to
    the log-sum-exp of the masked logits over the (5 + r) · bs slot keys,
    zero dq on the dense blocks, and the plain backward equal to autograd
    through the plain forward (fp32)."""
    nb, r = 6, 2
    q, k, v, rand, mask, w = _inputs(nb, r, 9, True, False, bs, 2, d)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous() for a in (q, k, v))
    tmask, trand = torch.from_numpy(mask), torch.from_numpy(rand)
    out, lse = tsparse.bigbird_mid_fwd(tq, tk, tv, tmask, trand, bs)
    assert out.shape == (B, (nb - 2) * bs, 2, d) and lse.shape == (B, 2, (nb - 2) * bs)
    qm, kc, _, pen, _ = tsparse._mid_operands(tq, tk, tv, tmask, trand, bs)
    want = torch.logsumexp(tsparse._mid_logits(qm, kc, pen, torch.float32), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.reshape(B, 2, -1).numpy(), atol=1e-5, rtol=0)
    g = torch.from_numpy(w).transpose(1, 2)[:, bs:-bs].contiguous()
    dq, dk, dv = tsparse.bigbird_mid_bwd(tq, tk, tv, tmask, trand, bs, out, lse, g)
    assert torch.count_nonzero(dq[:, :bs]) == 0 and torch.count_nonzero(dq[:, -bs:]) == 0
    aq, ak, av = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    ctx = tsparse.bigbird_mid_fwd_plain(aq, ak, av, tmask, trand, bs)[0]
    auto = torch.autograd.grad((ctx * g).sum(), (aq, ak, av))
    for name, got, want_g in zip(("dq", "dk", "dv"), (dq, dk, dv), auto):
        np.testing.assert_allclose(got.numpy(), want_g.numpy(), err_msg=name, **GRAD_TOL)


def _bf16_steps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 steps of |want| (8 significant bits)."""
    w = np.maximum(np.abs(want), 2.0 ** -100)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(w)) - 7)


def test_bf16_logit_scale_rounds_as_jax():
    """In bf16 the logits are round(round(Q·Kᵀ) · 1/√D) with the scale itself
    in bf16, as JAX multiplies a bf16 array by a Python float: bit-equal to
    JAX at D=32 (where 1/√32 is not a power of two) and at D=16, 64; the
    dense first and last query blocks scale the same way: on integer-valued
    q and k (Q·Kᵀ exact in any order) their context is within one bf16 step
    of JAX's (the fp32 scale puts hundreds of steps between them)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=4096) * 20).astype(np.float32)
    for d in (16, 32, 64):
        want = np.asarray((jnp.asarray(x).astype(jnp.bfloat16) * (1.0 / d ** 0.5))
                          .astype(jnp.float32))
        got = (torch.from_numpy(x).to(torch.bfloat16)
               * tsparse._scale_in(torch.bfloat16, d)).float().numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"D={d}")
    assert float(tsparse._scale_in(torch.bfloat16, 32)) == 0.1767578125
    assert float(tsparse._scale_in(torch.float32, 32)) == np.float32(1 / np.sqrt(32))
    bs = 48
    q, k, v, rand, mask, _ = _inputs(6, 2, 4, True, False, bs, 2, 32)
    q, k = (np.rint(a * 6) for a in (q, k))
    bf = torch.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(bf) for a in (q, k, v))
    got = tsparse.block_sparse_attention(tq, tk, tv, rand, torch.from_numpy(mask), bs)
    want = jsparse.block_sparse_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                          jnp.asarray(rand), jnp.asarray(mask), bs)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    for rows in (slice(0, bs), slice(-bs, None)):
        assert _bf16_steps(got[:, :, rows], want[:, :, rows]).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


def test_mid_blocks_plain_shapes_and_lse():
    """The plain forward's lse is the log-sum-exp of its masked logits,
    and the backward returns zero dq on the dense first and last blocks."""
    nb, r = 6, 2
    q, k, v, rand, mask, _ = _inputs(nb, r, 3, True, False)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    tmask, trand = torch.from_numpy(mask), torch.from_numpy(rand)
    out, lse = tsparse.bigbird_mid_fwd(tq, tk, tv, tmask, trand, BS)
    assert out.shape == (B, (nb - 2) * BS, H, D) and lse.shape == (B, H, (nb - 2) * BS)
    assert torch.isfinite(lse).all()
    dq, dk, dv = tsparse.bigbird_mid_bwd(tq, tk, tv, tmask, trand, BS, out, lse,
                                         torch.ones_like(out))
    assert dq.shape == tq.shape and dk.shape == tk.shape and dv.shape == tv.shape
    assert torch.count_nonzero(dq[:, :BS]) == 0 and torch.count_nonzero(dq[:, -BS:]) == 0
    with pytest.raises(ValueError, match="at least 5 blocks"):
        tsparse.bigbird_mid_fwd(tq[:, :4 * BS], tk[:, :4 * BS], tv[:, :4 * BS],
                                tmask[:, :4 * BS], trand[:, :2], BS)


def test_mid_blocks_plain_shapes_and_lse_block128():
    """The plain pair at the kernels' block 128 (S=1280, nb=10): the
    shapes, the lse equal to the log-sum-exp of the masked logits over
    the (5 + r) · 128 slot keys, and zero dq on the dense blocks."""
    nb, r, bs = 10, 2, 128
    q, k, v, rand, mask, _ = _inputs(nb, r, 4, True, False, bs, 2)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    tmask, trand = torch.from_numpy(mask), torch.from_numpy(rand)
    out, lse = tsparse.bigbird_mid_fwd(tq, tk, tv, tmask, trand, bs)
    assert out.shape == (B, (nb - 2) * bs, 2, D) and lse.shape == (B, 2, (nb - 2) * bs)
    qm, kc, _, pen, idx = tsparse._mid_operands(tq, tk, tv, tmask, trand, bs)
    assert kc.shape == (B, 2, nb - 2, (5 + r) * bs, D) and idx.shape == (2, nb - 2, 5 + r)
    logits = tsparse._mid_logits(qm, kc, pen, torch.float32)
    want = torch.logsumexp(logits, dim=-1).reshape(B, 2, -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)
    dq, dk, dv = tsparse.bigbird_mid_bwd(tq, tk, tv, tmask, trand, bs, out, lse,
                                         torch.ones_like(out))
    assert dq.shape == tq.shape and dk.shape == tk.shape and dv.shape == tv.shape
    assert torch.count_nonzero(dq[:, :bs]) == 0 and torch.count_nonzero(dq[:, -bs:]) == 0
    assert torch.count_nonzero(dq[:, bs:-bs]) > 0


@pytest.mark.parametrize("plan,padded", [("eval", False), ("eval", True), ("train", True)])
def test_sdpa_over_gathered_operands_matches_plain(plan, padded):
    """The library yardstick computes the plain forward's context: the eval
    plan's repeated blocks stay separate keys, and the mask's and the
    duplicate window slot's penalties enter as the float mask."""
    nb, r = 8, 2
    q, k, v, rand, mask, _ = _inputs(nb, r, 5, padded, plan == "eval")
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    tmask, trand = torch.from_numpy(mask), torch.from_numpy(rand)
    want, _ = tsparse.bigbird_mid_fwd_plain(tq, tk, tv, tmask, trand, BS)
    ops = bigbird_sdpa.gathered_operands(tq, tk, tv, tmask, trand, BS)
    qg, kg, vg, bias = ops
    n = B * H * (nb - 2)
    assert qg.shape == (n, 1, BS, D) and kg.shape == vg.shape == (n, 1, (5 + r) * BS, D)
    assert bias.shape == (n, 1, 1, (5 + r) * BS) and bias.dtype == tq.dtype
    assert all(t.is_contiguous() for t in ops)
    got = bigbird_sdpa.to_ctx(bigbird_sdpa.sdpa_mid(qg, kg, vg, bias), B, H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_tma_map_args_follow_the_view_strides():
    """The kernels' 4-D tensor maps (dims D, H, S, B; byte strides of H, S
    and B; box D x 1 x 64 x 1) over contiguous, fused-QKV and head-major
    views, and the views a map cannot take, which the wrapper copies."""
    Bq, S, Hq, Dq = 2, 256, 12, 64
    bf = torch.bfloat16
    x = torch.zeros(Bq, S, Hq, Dq, dtype=bf)
    row = Hq * Dq * 2
    assert tsparse.tma_map_args(x) == ((Dq, Hq, S, Bq), (Dq * 2, row, row * S), (Dq, 1, 64, 1))
    fused = torch.zeros(Bq, S, 3, Hq, Dq, dtype=bf)[:, :, 1]
    assert tsparse.tma_map_args(fused) == ((Dq, Hq, S, Bq), (Dq * 2, 3 * row, 3 * row * S),
                                           (Dq, 1, 64, 1))
    heads = torch.zeros(Bq, Hq, S, Dq, dtype=bf).transpose(1, 2)
    assert tsparse.tma_map_args(heads) == ((Dq, Hq, S, Bq), (S * Dq * 2, Dq * 2, row * S),
                                           (Dq, 1, 64, 1))
    # a row of 66 bf16 (132 bytes) and a non-unit last stride: no map
    ragged = torch.zeros(Bq, S, Hq, 66, dtype=bf)[..., :Dq]
    assert tsparse.tma_map_args(ragged) is None
    assert tsparse.tma_map_args(torch.zeros(Bq, S, Hq, 2 * Dq, dtype=bf)[..., ::2]) is None
    q, k, v, strides = tsparse._strided_qkv(ragged, ragged, ragged)
    assert q.is_contiguous() and strides == (S * Hq * Dq, Hq * Dq, Dq)
    q, k, v, strides = tsparse._strided_qkv(fused, fused, fused)
    assert q.data_ptr() == fused.data_ptr() and strides == fused.stride()[:3]


def test_tma_map_args_at_block128():
    """At block 128 the kernels read a 128-key slot as two 64-row tiles:
    the map over the trunk's fused-QKV view (S=4096) keeps the 64-row
    box, and a block of 128 rows is two boxes of it (every block size the
    kernels take is ⌈bs/64⌉ boxes, the last one partial below 64)."""
    Bq, S, Hq, Dq = 2, 4096, 12, 64
    fused = torch.zeros(Bq, S, 3, Hq, Dq, dtype=torch.bfloat16)[:, :, 0]
    row = 3 * Hq * Dq * 2
    dims, strides, box = tsparse.tma_map_args(fused)
    assert dims == (Dq, Hq, S, Bq) and strides == (Dq * 2, row, row * S)
    assert box == (Dq, 1, tsparse.KERNEL_TILE, 1)
    assert tsparse.bigbird_kernel_takes(128, Dq, S) and 128 // box[2] == 2
    assert tsparse.bigbird_kernel_takes(64, Dq, S) and 64 // box[2] == 1


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

BB = jconfig.BigBirdConfig(
    vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, max_position_embeddings=64, block_size=4, num_random_blocks=1,
    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
S_SPARSE = 32   # > (5 + 2r) * bs = 28: block-sparse
# the kernels' block 128: S=1024 > (5 + 2r) * bs = 896, block-sparse
BB128 = dataclasses.replace(BB, hidden_size=16, intermediate_size=32,
                            max_position_embeddings=1024, block_size=128)
S_SPARSE_128 = 1024


def port_bigbird_cfg(cfg):
    return tconfig.BigBirdConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def bb_params():
    return jax.tree.map(np.asarray, jbigbird.init_bigbird_params(jax.random.PRNGKey(0), BB))


@pytest.fixture(scope="module")
def bb128_params():
    return jax.tree.map(np.asarray, jbigbird.init_bigbird_params(jax.random.PRNGKey(3), BB128))


def _encoder_inputs(seed, S=S_SPARSE, hidden=BB.hidden_size):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(3, S, hidden)).astype(np.float32)
    mask = np.ones((3, S), np.int32)
    mask[1, 20:] = 0
    mask[2, 9:] = 0
    if S > S_SPARSE:        # at block 128, row 1's pad starts inside a middle block
        mask[1, 20:650] = 1
    return emb, mask


@pytest.mark.parametrize("attention_type,cls_only,training,block", [
    ("block_sparse", False, False, 4), ("block_sparse", True, False, 4),
    ("original_full", False, False, 4), ("original_full", True, False, 4),
    ("block_sparse", False, True, 4),
    ("block_sparse", False, False, 128), ("block_sparse", False, True, 128),
], ids=["sparse", "sparse-cls", "full", "full-cls", "sparse-train-plan", "sparse-bs128",
        "sparse-train-plan-bs128"])
def test_bigbird_model_matches_jax(request, attention_type, cls_only, training, block):
    cfg = BB if block == BB.block_size else BB128
    bb_params = request.getfixturevalue("bb_params" if cfg is BB else "bb128_params")
    if cfg is BB:
        emb, mask = _encoder_inputs(1)
    else:
        emb, mask = _encoder_inputs(1, S_SPARSE_128, cfg.hidden_size)
        assert jbigbird.effective_attention_type(cfg, S_SPARSE_128) == "block_sparse"
    jseq, jpool = jbigbird.bigbird_model(
        jax.tree.map(jnp.asarray, bb_params), cfg, inputs_embeds=jnp.asarray(emb),
        attention_mask=jnp.asarray(mask), attention_type=attention_type, cls_only=cls_only,
        deterministic=not training, dropout_rng=jax.random.PRNGKey(0) if training else None)
    tp = bigbird_params_from_jax(bb_params, port_bigbird_cfg(cfg))
    tseq, tpool = tbigbird.bigbird_model(
        tp, port_bigbird_cfg(cfg), inputs_embeds=torch.from_numpy(emb),
        attention_mask=torch.from_numpy(mask), attention_type=attention_type,
        cls_only=cls_only, deterministic=not training)
    assert tseq.shape == jseq.shape
    np.testing.assert_allclose(tseq.detach().numpy(), np.asarray(jseq), **FWD_TOL)
    np.testing.assert_allclose(tpool.detach().numpy(), np.asarray(jpool), **FWD_TOL)


def test_bigbird_embed_and_attention_type(bb_params):
    """Token ids through the embeddings (dropout before LayerNorm, token
    types all zero), and HF's fallback to full attention."""
    ids = np.random.default_rng(2).integers(0, BB.vocab_size, (2, 12))
    want = jbigbird.embed(jax.tree.map(jnp.asarray, bb_params), BB, input_ids=jnp.asarray(ids))
    got = tbigbird.embed(bigbird_params_from_jax(bb_params, port_bigbird_cfg(BB)),
                         port_bigbird_cfg(BB), input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    tcfg = port_bigbird_cfg(BB)
    for S in (28, 32, 64):
        assert (tbigbird.effective_attention_type(tcfg, S)
                == jbigbird.effective_attention_type(BB, S))
    full = dataclasses.replace(tcfg, attention_type="original_full")
    assert tbigbird.effective_attention_type(full, 64) == "original_full"


def test_bigbird_unported_options_raise(bb_params):
    tcfg = port_bigbird_cfg(BB)
    tp = bigbird_params_from_jax(bb_params, tcfg)
    emb = torch.zeros(1, S_SPARSE, BB.hidden_size)
    with pytest.raises(ValueError, match="remat"):
        tbigbird.bigbird_model(tp, tcfg, inputs_embeds=emb, remat="selective")
    with pytest.raises(ValueError, match="cls_only"):
        tbigbird.bigbird_model(tp, tcfg, inputs_embeds=emb, cls_only=True, deterministic=False)
    with pytest.raises(ValueError, match="block id"):
        tbigbird.bigbird_model(tp, tcfg, inputs_embeds=emb,
                               rand_attn=np.full((2, 2, 6, 1), 99, np.int32))
