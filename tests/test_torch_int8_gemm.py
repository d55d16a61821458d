"""The int8 GEMM probe's plain version against numpy and the JAX probe's
XLA variant, on the CPU.

On a CPU tensor ``int8_gemm`` runs its plain version: int8 -> int32 through
an fp64 matmul, exact while |C| < 2^53, and bf16 -> fp32 through an fp32
matmul, for B row-major or column-major (the kernel's K-major operand).
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.  Tolerance of the bf16 control: products of bf16
values are exact in fp32, only the order of the fp32 sums differs, so
1e-5 relative to the largest value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu_torch.benchmarks import bench_int8_gemm as probe


def _int8(rng, shape):
    return rng.integers(-127, 127, shape).astype(np.int8)


@pytest.mark.parametrize("tiles", probe.TILES)
def test_int8_plain_is_exact(tiles):
    """At one tile of every instantiated shape, and at 127 x 127 products
    summed over K = 1,024 (the largest sums the test can make cheaply)."""
    rng = np.random.default_rng(0)
    bm, bn, bk = tiles
    a, b = _int8(rng, (bm, 2 * bk)), _int8(rng, (2 * bk, bn))
    launches = probe.int8_gemm.launches
    got = probe.int8_gemm(torch.from_numpy(a), torch.from_numpy(b), tiles)
    assert probe.int8_gemm.launches == launches      # CPU: no kernel
    assert got.dtype == torch.int32 and got.shape == (bm, bn)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    xla = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


def test_int8_plain_at_the_extremes():
    a = np.full((128, 1024), -127, np.int8)
    b = np.full((1024, 128), 127, np.int8)
    got = probe.int8_gemm(torch.from_numpy(a), torch.from_numpy(b), (128, 128, 128))
    assert int(got.min()) == int(got.max()) == -127 * 127 * 1024


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (256, 384, 256), (128, 1024, 512)])
def test_plain_on_a_column_major_b(M, K, N):
    """B as ``operands`` makes it on the card, a column-major (K, N) view
    (the kernel's K-major operand): the same product as a row-major B, in
    int8 exactly and in bf16 bit for bit."""
    rng = np.random.default_rng(2)
    a, bt = _int8(rng, (M, K)), _int8(rng, (N, K))
    b_col = torch.from_numpy(bt).t()
    assert b_col.shape == (K, N) and not b_col.is_contiguous() and b_col.t().is_contiguous()
    tiles = next(t for t in probe.TILES if M % t[0] == 0 and N % t[1] == 0)
    got = probe.int8_gemm(torch.from_numpy(a), b_col, tiles)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ bt.T.astype(np.int64))
    assert torch.equal(got, probe.int8_gemm(torch.from_numpy(a), b_col.contiguous(), tiles))
    af = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    bf = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(torch.bfloat16).t()
    assert torch.equal(probe.int8_gemm(af, bf, tiles), probe.int8_gemm(af, bf.contiguous(), tiles))


def test_bf16_plain_matches_fp32_product():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(128, 256)).astype(np.float32)
    b = rng.normal(size=(256, 128)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    got = probe.int8_gemm(ta, tb, (128, 128, 128))
    assert got.dtype == torch.float32
    want = ta.float().numpy().astype(np.float64) @ tb.float().numpy().astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_tile_shapes_and_operands_are_checked():
    a8 = torch.zeros(128, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="do not divide"):
        probe.int8_gemm(a8[:100], a8, (128, 128, 128))        # M % bm
    with pytest.raises(ValueError, match="do not divide"):
        probe.int8_gemm(a8, torch.zeros(128, 96, dtype=torch.int8), (128, 128, 128))  # N % bn
    with pytest.raises(ValueError, match="do not divide"):
        probe.int8_gemm(a8[:, :96], torch.zeros(96, 128, dtype=torch.int8),
                        (128, 128, 128))                        # K bytes % bk
    with pytest.raises(ValueError, match="do not divide"):
        probe.int8_gemm(a8.to(torch.bfloat16)[:, :32], torch.zeros(32, 128, dtype=torch.bfloat16),
                        (128, 128, 128))                        # 64 bf16 a stage
    with pytest.raises(ValueError, match="not instantiated"):
        probe.int8_gemm(a8, a8, (512, 512, 1024))               # a TPU tile
    with pytest.raises(TypeError):
        probe.int8_gemm(a8, a8.to(torch.bfloat16))
    with pytest.raises(ValueError, match="A \\(M, K\\)"):
        probe.int8_gemm(a8, torch.zeros(64, 128, dtype=torch.int8))
    with pytest.raises(ValueError, match="multiple of 1024"):
        probe.main(size=1000)
