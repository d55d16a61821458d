"""Microbenchmark: does an int8 GEMM written by hand reach twice the bf16
rate on the H100 (1,979 int8 TOP/s against 989 bf16 TFLOP/s)?

The port of the JAX package's ``benchmarks/bench_int8_gemm.py``, the probe
that gated the int8 serving mode.  Run on one CUDA card::

    python -m stonkgs_tpu_torch.benchmarks.bench_int8_gemm [--size 4096] [--sweep]

``main`` first checks the kernel's int8 result against its plain version,
exactly, at 512 x 1024 x 512 and at ``size``^3, then prints one JSON line
per variant at ``size``^3 with its TFLOP/s: ``torch.mm`` in bf16 with fp32
out, ``torch._int_mm`` (int8 -> int32), the kernel on int8 and the kernel
on bf16 (the control).  ``sweep`` times the kernel at every instantiated
tile shape.  The two PyTorch calls are yardsticks, not ports.

Kernel: ``csrc/int8_gemm.cu`` over ``csrc/int8_sm90.cuh`` (CUDA C++ for
``sm_90a``).  It replaces the TPU kernel ``_matmul_kernel``
(``benchmarks/bench_int8_gemm.py:27``, launched at ``:46``): a tiled GEMM
``C = A . B``, int8 -> int32 or bf16 -> fp32.  At 4096^3 it is bound by
operations: 137.4 GOP is 0.069 ms at 1,979 int8 TOP/s (0.139 ms at 989
bf16 TFLOP/s), against 0.030 ms for the bytes (A and B int8, C int32;
0.040 ms in bf16 with fp32 out).

Design: the TPU kernel walks k in its sequential grid and carries the sum
in a VMEM scratch accumulator; a Hopper block owns a (bm, bn) tile of C
and walks K itself with the sum in registers: the int8 dense's GEMM core
without its dequantizing epilogue.  A producer warpgroup streams A and B
through a TMA ring, one 128-byte swizzled line of K a stage (``bk`` =
128 bytes: 128 int8 or 64 bf16 values); two consumer warpgroups issue
``wgmma.m64nNk32.s32.s8.s8`` (the bf16 control
``wgmma.m64nNk16.f32.bf16.bf16``); C leaves through TMA stores.  ``wgmma``
takes 8-bit operands only K-major, so B is read as B^T (N, K): a
column-major B (as :func:`operands` makes it, and as cuBLASLt prefers it
for ``torch._int_mm``) is passed as it lies, any other B is copied for
the call.  The tile shapes are template parameters (:data:`TILES`); the
TPU sweep's VMEM tiles, such as (2048, 512, 2048), do not fit in a
block's 227 KB of shared memory and are not copied.  A shape the tiles do
not divide raises ``ValueError``, as the JAX probe exits for it.

The plain version computes the int8 product as an fp64 matmul (exact:
|C| <= 127^2 * K < 2^53) and the bf16 one as an fp32 matmul.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, Tuple

import torch

from stonkgs_tpu_torch.benchmarks._util import emit, require_cuda, time_ms
from stonkgs_tpu_torch.ops import _build

# the instantiated (bm, bn, bk) tiles of csrc/int8_gemm.cu: rows and
# columns of a C tile, and the K bytes of a ring stage (128 int8 or 64
# bf16 values)
TILES = ((128, 128, 128), (128, 256, 128), (256, 128, 128))
# the fastest int8 tile of the sweep at 4096^3 on an H100 SXM (PERF.md)
DEFAULT_TILES = (128, 256, 128)
_DTYPES = {torch.int8: 0, torch.bfloat16: 1}
_OUT = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
_P, _I = _build.P, _build.I32
# int int8_gemm(dtype, bm, bn, bk, a, bt, c, M, N, K, stream), bt = B^T (N, K)
_SIGNATURES = {"int8_gemm": [_I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P]}


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int8 -> int32 through an exact fp64 matmul,
    bf16 -> fp32 through an fp32 matmul."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def _check(a, b, tiles) -> Tuple[int, int, int]:
    """(M, N, K), checked against the operands and the tile shape."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_gemm takes A (M, K) and B (K, N), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"int8_gemm takes int8 or bf16 operands of one dtype, got "
                        f"{a.dtype}, {b.dtype}")
    if tuple(tiles) not in TILES:
        raise ValueError(f"tiles {tuple(tiles)} are not instantiated; choose from {TILES}")
    (M, K), N = a.shape, b.shape[1]
    bm, bn, bk = tiles
    if M % bm or N % bn or (K * a.element_size()) % bk or min(M, N, K) == 0:
        raise ValueError(f"the tiles {tuple(tiles)} do not divide M={M}, N={N}, K={K} "
                         "(no remainder handling)")
    return M, N, K


def int8_gemm(a: torch.Tensor, b: torch.Tensor, tiles=DEFAULT_TILES) -> torch.Tensor:
    """C = A . B, int8 -> int32 or bf16 -> fp32, with the given tiles.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises).  B is read without a copy when it is
    column-major (B^T contiguous)."""
    M, N, K = _check(a, b, tiles)
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"int8_gemm: unsupported devices {a.device}, {b.device}")
    a, bt = a.contiguous(), b.t().contiguous()
    c = torch.empty((M, N), dtype=_OUT[a.dtype], device=a.device)
    _build.check_aligned("int8_gemm", a, bt, c)
    lib = _build.load("int8_gemm", _SIGNATURES)
    status = lib.int8_gemm(_DTYPES[a.dtype], *tiles, _build.ptr(a), _build.ptr(bt),
                           _build.ptr(c), M, N, K, _build.stream(a.device))
    _build.check(status, "int8_gemm")
    int8_gemm.launches += 1
    return c


int8_gemm.launches = 0


def operands(M: int, K: int, N: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded operands on the card: int8 codes in [-127, 127) and bf16
    normals, as the JAX probe draws them; each B a column-major (K, N)
    view, the layout the kernel and cuBLASLt read as they lie."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {
        "a8": torch.randint(-127, 127, (M, K), generator=gen, device="cuda", dtype=torch.int8),
        "b8": torch.randint(-127, 127, (N, K), generator=gen, device="cuda",
                            dtype=torch.int8).t(),
        "abf": torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16),
        "bbf": torch.randn(N, K, generator=gen, device="cuda").to(torch.bfloat16).t(),
    }


def check_exact(a8: torch.Tensor, b8: torch.Tensor, tiles=DEFAULT_TILES) -> None:
    """Raise unless the kernel's int8 product equals the plain version."""
    got, want = int8_gemm(a8, b8, tiles), int8_gemm_plain(a8, b8)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"int8 GEMM mismatch at {tuple(a8.shape)} x {tuple(b8.shape)}: "
                           f"{bad} elements differ")


def main(size: int = 4096, steps: int = 20) -> Dict[str, dict]:
    """The exactness checks, then the four variants at ``size``^3; returns
    each variant's record by name."""
    if size % 1024:
        raise ValueError("size must be a multiple of 1024 (the tiles divide the problem "
                         "exactly; no remainder handling)")
    card = require_cuda()
    M = K = N = size
    ops = operands(M, K, N)
    check_exact(ops["a8"][:512, :1024], ops["b8"][:1024, :512])
    check_exact(ops["a8"], ops["b8"])
    flops = 2.0 * M * N * K
    variants = [
        ("torch bf16", lambda: torch.mm(ops["abf"], ops["bbf"], out_dtype=torch.float32)),
        ("torch int8", lambda: torch._int_mm(ops["a8"], ops["b8"])),
        ("kernel int8", lambda: int8_gemm(ops["a8"], ops["b8"])),
        ("kernel bf16 (control)", lambda: int8_gemm(ops["abf"], ops["bbf"])),
    ]
    out = {}
    for name, fn in variants:
        ms = time_ms(fn, iters=steps)
        out[name] = emit(f"GEMM {size}^3 [{name}]", flops / ms / 1e9, "TFLOP/s", ms=ms,
                         tiles=list(DEFAULT_TILES) if name.startswith("kernel") else None,
                         card=card)
    return out


def sweep(size: int = 4096, steps: int = 20) -> Dict[str, dict]:
    """The kernel at every instantiated tile shape, int8 and bf16."""
    if size % 256:
        raise ValueError("size must be a multiple of 256 for the sweep")
    card = require_cuda()
    ops = operands(size, size, size)
    flops = 2.0 * size ** 3
    out = {}
    for tiles in TILES:
        for name, a, b in (("int8", ops["a8"], ops["b8"]), ("bf16", ops["abf"], ops["bbf"])):
            if name == "int8":
                check_exact(a, b, tiles)
            ms = statistics.median(time_ms(lambda: int8_gemm(a, b, tiles), iters=steps)
                                   for _ in range(3))
            label = f"GEMM {size}^3 kernel {name} tiles={tiles}"
            out[label] = emit(label, flops / ms / 1e9, "TFLOP/s", ms=ms, card=card)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if args.sweep:
        sweep(args.size, args.steps)
    else:
        main(args.size, args.steps)
