"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper of ``stonkgs_tpu_torch.ops`` runs its
kernel's plain PyTorch version, so these tests hold that plain version
against the JAX package's Pallas kernel in interpret mode (and against
its XLA counterpart).  The CUDA kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 atol 1e-5 (the JAX FFN kernel's Abramowitz-Stegun erf
is off by < 1.5e-7; sums run in another order); bf16 atol 2e-2, a few
bf16 steps at these magnitudes, because the two frameworks may round an
intermediate to the other neighbour.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stonkgs_tpu.ops import attention as jattn
from stonkgs_tpu.ops import flash_attention as jflash
from stonkgs_tpu.ops import fused_ffn as jffn
from stonkgs_tpu_torch.ops import attention as tattn
from stonkgs_tpu_torch.ops import flash_attention as tflash
from stonkgs_tpu_torch.ops import fused_ffn as tffn

TOL = {"float32": dict(atol=1e-5, rtol=0.0), "bfloat16": dict(atol=2e-2, rtol=0.0)}


def _ffn_inputs(M, H=64, I=128, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [
        rng.normal(size=(M, H)).astype(f),              # x
        rng.normal(size=(M, H)).astype(f),              # attn_out
        (1.0 + 0.1 * rng.normal(size=H)).astype(f),     # ln1 scale
        (0.1 * rng.normal(size=H)).astype(f),           # ln1 bias
        (0.1 * rng.normal(size=(H, I))).astype(f),      # w1
        (0.1 * rng.normal(size=I)).astype(f),           # b1
        (0.1 * rng.normal(size=(I, H))).astype(f),      # w2
        (0.1 * rng.normal(size=H)).astype(f),           # b2
        (1.0 + 0.1 * rng.normal(size=H)).astype(f),     # ln2 scale
        (0.1 * rng.normal(size=H)).astype(f),           # ln2 bias
    ]


def _as_dtype(arrays, dtype, n_act=2):
    """The activations (first ``n_act`` arrays) in ``dtype``, the rest fp32,
    for both frameworks."""
    jx = [jnp.asarray(a, getattr(jnp, dtype) if i < n_act else jnp.float32)
          for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype) if i < n_act else torch.float32)
          for i, a in enumerate(arrays)]
    return jx, tx


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
# 127, 128 and 129: the edges of the card's 128-row GEMM tile (the plain
# version the card compares with does not depend on the width)
@pytest.mark.parametrize("M", [1, 3, 37, 127, 128, 129])
def test_fused_ffn_ln_block_matches_pallas_kernel(M, act, dtype):
    jx, tx = _as_dtype(_ffn_inputs(M), dtype)
    want = jffn.fused_ffn_ln_block(*jx, act=act, eps=1e-12, block_m=16,
                                   interpret=True)
    launches = tffn.fused_ffn_ln_block.launches
    got = tffn.fused_ffn_ln_block(*tx, act=act, eps=1e-12)
    assert tffn.fused_ffn_ln_block.launches == launches  # CPU: no kernel
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_fused_ffn_ln_block_3d_input_and_bad_args():
    arrays = _ffn_inputs(12)
    _, tx = _as_dtype(arrays, "float32")
    flat = tffn.fused_ffn_ln_block(*tx)
    x3 = [tx[0].reshape(3, 4, 64), tx[1].reshape(3, 4, 64)] + tx[2:]
    np.testing.assert_array_equal(
        tffn.fused_ffn_ln_block(*x3).reshape(12, 64).numpy(), flat.numpy())
    with pytest.raises(ValueError, match="activation"):
        tffn.fused_ffn_ln_block(*tx, act="relu")
    meta = [t.to("meta") for t in tx]
    with pytest.raises(ValueError, match="device"):
        tffn.fused_ffn_ln_block(*meta)


def _attn_inputs(S, B=2, H=4, D=16, seed=0, masked=True):
    rng = np.random.default_rng(seed + S)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    bias = None
    if masked:
        lengths = rng.integers(1, S + 1, size=B)
        keep = np.arange(S)[None, :] < lengths[:, None]
        bias = ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias


def _attn_pair(arrays, dtype):
    q, k, v, bias = arrays
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    return jx, jb, tx, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("S", [1, 7, 33, 64, 129])   # 129 crosses a 128-key tile
def test_flash_attention_infer_matches_pallas_kernel(S, masked, dtype):
    jx, jb, tx, tb = _attn_pair(_attn_inputs(S, masked=masked), dtype)
    want = jflash.flash_attention_infer(*jx, jb, interpret=True)
    launches = tflash.flash_attention_infer.launches
    got = tflash.flash_attention_infer(*tx, tb)
    assert tflash.flash_attention_infer.launches == launches
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("S", [1, 7, 33, 64])
def test_flash_attention_infer_matches_xla_attention_fp32(S, masked):
    jx, jb, tx, tb = _attn_pair(_attn_inputs(S, masked=masked), "float32")
    want = jattn._xla_attention(*jx, jb, dropout_rate=0.0, dropout_rng=None,
                                deterministic=True, precision="highest")
    got = tattn.dot_product_attention(*tx, tb)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq", [1, 9])
def test_plain_attention_matches_xla_attention(Sq, dtype):
    """The cls_only layer's einsum attention (one query row against S keys)."""
    q, k, v, bias = _attn_inputs(9, masked=True)
    q = q[:, :Sq]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    want = jattn._xla_attention(*jx, jnp.asarray(bias), dropout_rate=0.0,
                                dropout_rng=None, deterministic=True,
                                precision="highest")
    got = tattn.plain_attention(*tx, torch.from_numpy(bias))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_attention_rejects_training_and_bad_bias():
    """Training attention takes a dropout rate in [0, 1); a bias must be
    (B, 1, 1, S); a tensor on neither the CPU nor a card is refused."""
    _, _, tx, tb = _attn_pair(_attn_inputs(7), "float32")
    with pytest.raises(ValueError, match="rate"):
        tattn.dot_product_attention(*tx, tb, deterministic=False, dropout_rate=1.0,
                                    seed=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="bias"):
        tflash.flash_attention_infer(*tx, tb[:, 0])
    with pytest.raises(ValueError, match="device"):
        tflash.flash_attention_infer(*[t.to("meta") for t in tx])
