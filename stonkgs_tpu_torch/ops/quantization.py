"""Int8 serving mode of the port: quantized parameters and the int8 dense.

The port of the JAX package's ``stonkgs_tpu/ops/quantization.py`` (the
parameter quantization and the dense it dispatches to) and
``ops/quantization_pallas.py`` (the fused kernel), in one module.  An
opt-in approximation for serving: ``params_q = quantize_params(params)``,
then the engines as usual; :func:`stonkgs_tpu_torch.models.bert.dense`
sends every leaf that holds ``kernel_q`` to :func:`dense_int8`.

Weights: int8 codes with one fp32 scale per output column (symmetric,
absmax over the input axis).  Activations: int8 codes with one scale per
row, computed at run time.  The product runs int8 x int8 -> int32; the
epilogue is ``acc * s_x * s_w + bias`` in fp32, rounded once to x's dtype.

Kernel: the fused int8 dense
============================

``csrc/dense_int8.cu`` over ``csrc/int8_sm90.cuh`` (CUDA C++ for
``sm_90a``).  It replaces the TPU
kernel ``_fused_kernel`` (``stonkgs_tpu/ops/quantization_pallas.py:33``,
launched at ``:77``).  The TPU wrapper's gate (``supported``: K and N
multiples of 128, W under 8 MB of VMEM) and its padding of M to 256 rows
are Mosaic needs and are not copied: the kernel takes every leaf that
:func:`quantize_params` makes, the decoders (N = 28,996 and 100,000)
included, for any M, any N >= 1 and any K >= 1, as the JAX package's
``dense_int8`` does on every device.

Any K.  The kernel steps K by :data:`K_MULTIPLE` = 16.  A K that is no
multiple of it (the 100-wide KG vectors' Q/K/V/O and W1 at K = 100) runs
on zero padding to Kp, the next multiple: a zero leaves a row's absmax
(over the true K) as it is and quantizes to code 0, and a zero code adds
nothing to the int32 sum.  W is padded once, where :func:`quantized_to`
lays it out column-major on the card (rows of Kp codes; the GEMM's tensor
maps take the true K, so TMA zero-fills the last k-step past it and the
padding is never read).  x is padded in the wrapper, a copy of the
(M, Kp) rows for each call at a ragged K only (the pass reads 16-byte
vectors, and a row of 100 bf16 is 200 bytes); at every K that is a
multiple of 16 nothing is copied.

What bounds it on the H100 (each input byte once, each output byte once;
x and y bf16, W int8; 3.35 TB/s and 1,979 int8 TOP/s): at M = 65,536 the
768 -> 768 projections move 201.9 MB for 77 GOP (0.060 ms, bytes); the
768 -> 3072 and 3072 -> 768 products are 309 GOP (0.156 ms, operations).
The two-pass design below also writes and reads the int8 codes (M, K)
once.  Its own floor, the pass's bound plus the GEMM's, is at the trunk
0.090 ms (Q/K/V/O), 0.201 ms (FFN in) and 0.336 ms (FFN out, where the
pass alone moves 604 MB, 0.180 ms).

Design.  The TPU kernel keeps the whole (K, N) weight in VMEM and takes
256 rows at a time, quantizing them in the kernel.  On Hopper a call is
two launches (``csrc/int8_sm90.cuh``), so that each row is quantized once
(a block of one launch that quantized its rows would do so once for each
of the N / 256 column tiles):

1. the row-quantize pass: one to eight warps a row (at most four 16-byte
   vectors a lane) read x once through its row stride (the strided
   ``x[:, :1]`` [CLS] rows need no copy), keep the row in registers, and
   write ``s_x`` (M,) and the int8 codes into an (M, K) scratch;
2. the GEMM: one persistent block an SM walks 256 x 128 tiles of y; a
   producer warpgroup streams the codes and W through a 3-stage TMA ring
   (128 K values a stage) that runs on from tile to tile, two consumer
   warpgroups of 128 rows each issue ``wgmma.m64n128k32.s32.s8.s8`` into
   int32 registers, and the epilogue ``acc * s_x * s_w + b`` in fp32,
   each product rounded (``__fmul_rn``, ``__fadd_rn``: no fused
   multiply-add), is rounded once to x's dtype, staged in shared memory
   and stored with TMA while the next tile's first stages load.  TMA
   zero-fills rows past M and N and the last k-step's columns past K
   (the maps take the true K) and clips the store, so no store is
   guarded.

``wgmma`` takes 8-bit operands only K-major, both A and B.  W is kept
(K, N) in the tree, but on the card :func:`quantized_to` stores it as a
column-major view (``kernel_q.t().contiguous().t()``: the same shape,
values and keys), whose transpose is the (N, K) row-major operand the
GEMM reads.  Every engine moves its parameters through
:func:`~stonkgs_tpu_torch.utils.convert.params_to`, which calls it; a
row-major ``kernel_q`` on the card still works, through a K-major copy
made for the call.  fp32 and bf16 x share the GEMM; only the pass's input
and the epilogue's output type differ.

The plain version computes the int32 product as an fp64 matmul of the
codes: exact while |acc| < 2^53, on the CPU and on the card alike (CUDA
PyTorch has no int32 matmul).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from stonkgs_tpu_torch.ops import _build
from stonkgs_tpu_torch.ops.fused_ffn import _pad_to

# dense kernels are quantized when both dims are at least this (skips tiny
# projections where quantization costs more than it saves)
MIN_QUANT_DIM = 64
SKIP_KEYS = ("pooler",)   # the tanh pooler is scale-sensitive
K_MULTIPLE = 16           # the kernel's K step: other K run on zero padding to a multiple
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = _build.P, _build.I32, _build.I64
_SIGNATURES = {
    # int dense_int8(dtype, x, ldx, q, s_x, w, ldw, w_scale, bias, out, ldo, M, K, N,
    #                stream)
    "dense_int8": [_I, _P, _L, _P, _P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _P],
    # int dense_int8_quantize(dtype, x, ldx, q, s_x, M, Kp, stream)
    "dense_int8_quantize": [_I, _P, _L, _P, _P, _I, _I, _P],
    # int dense_int8_gemm(dtype, q, s_x, w, ldw, w_scale, bias, out, ldo, M, K, N, stream)
    "dense_int8_gemm": [_I, _P, _P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _P],
}


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax / 127, 1e-12) in fp32, as the JAX package.  The divisor
    is a tensor on absmax's device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can miss the IEEE quotient
    by one bit and flip a code."""
    return (absmax / absmax.new_tensor(127.0)).clamp_min(1e-12)


def _codes(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(v / scale), -127, 127) as int8; round half to even."""
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)


def quantize_kernel(kernel: torch.Tensor) -> dict:
    """(in, out) kernel -> {"kernel_q": int8 (in, out), "scale": fp32
    (out,)}, one scale per output column."""
    if kernel.dim() != 2:
        raise ValueError(f"quantize_kernel takes a 2-D (in, out) kernel, got "
                         f"{tuple(kernel.shape)}")
    k = kernel.detach().to(torch.float32)
    scale = _scale(k.abs().amax(dim=0))
    return {"kernel_q": _codes(k, scale), "scale": scale}


def _is_dense(tree) -> bool:
    return isinstance(tree, Mapping) and "kernel" in tree and tree["kernel"].dim() == 2


def quantize_params(params, *, skip_keys=SKIP_KEYS):
    """Quantize every eligible dense kernel of a parameter tree.

    A dense (a dict with a 2-D ``kernel``) is quantized when both its dims
    are at least :data:`MIN_QUANT_DIM` and its key is not in ``skip_keys``;
    its bias stays as it is.  Embedding tables, LayerNorms, the KG table
    and the skipped subtrees are returned unchanged.  Walks the port's
    dicts and lists of layers."""

    def rec(tree, key):
        if _is_dense(tree) and key not in skip_keys:
            kernel = tree["kernel"]
            if kernel.shape[0] >= MIN_QUANT_DIM and kernel.shape[1] >= MIN_QUANT_DIM:
                out = quantize_kernel(kernel)
                if "bias" in tree:
                    out["bias"] = tree["bias"]
                return out
        if isinstance(tree, Mapping):
            return {k: rec(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rec(v, key) for v in tree]
        return tree

    return rec(params, None)


def is_quantized(tree) -> bool:
    """Whether a subtree is a dense quantized by :func:`quantize_params`:
    ``{"kernel_q", "scale"[, "bias"]}``."""
    return isinstance(tree, Mapping) and "kernel_q" in tree


def padded_k(K: int) -> int:
    """K rounded up to a multiple of :data:`K_MULTIPLE`: the row length of
    the codes and of W's K-major layout on the card."""
    return -(-K // K_MULTIPLE) * K_MULTIPLE


def is_k_major(kernel_q: torch.Tensor) -> bool:
    """Whether ``kernel_q`` (K, N) is a view the GEMM reads as it lies: its
    transpose (N, K) has a unit column stride, rows of Kp codes and a
    16-byte aligned start (:func:`k_major`'s layout)."""
    K = kernel_q.shape[0]
    return (kernel_q.stride(0) == 1 and kernel_q.stride(1) == padded_k(K)
            and kernel_q.data_ptr() % 16 == 0)


def k_major(kernel_q: torch.Tensor) -> torch.Tensor:
    """``kernel_q`` (K, N) as a column-major view: the same shape and
    values, its transpose the (N, K) rows of the card's GEMM, each row Kp
    = :func:`padded_k` codes apart, the codes past K zero (no copy where it
    already is one)."""
    if is_k_major(kernel_q):
        return kernel_q
    K, N = kernel_q.shape
    wt = kernel_q.new_zeros((N, padded_k(K)))
    wt[:, :K] = kernel_q.t()
    return wt[:, :K].t()


def quantized_to(p: Mapping, device=None) -> dict:
    """A quantized dense moved to ``device``, every leaf in its own dtype:
    :func:`dense_int8` reads the scale and the bias in fp32 whatever the
    compute dtype.  On the card ``kernel_q`` is stored column-major with
    rows of Kp codes (:func:`k_major`), the layout the kernel reads
    without a copy."""
    out = {k: v.to(device) for k, v in p.items()}
    if out["kernel_q"].device.type == "cuda":
        out["kernel_q"] = k_major(out["kernel_q"])
    return out


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes of x (..., K) and their fp32 scales (..., 1)."""
    xf = x.to(torch.float32)
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return _codes(xf, scale), scale


def _dequant_plain(q, s, kernel_q, w_scale, bias, dtype):
    """The exact int32 product of the codes q (M, K) (an fp64 matmul) and
    ``acc * s_x * s_w (+ bias)`` in fp32, rounded to ``dtype``; s (M, 1)."""
    acc = (q.double() @ kernel_q.double()).to(torch.float32)
    y = acc * s * w_scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dtype)


def dense_int8_fused_plain(x, kernel_q, w_scale, bias=None):
    """Plain PyTorch version of the kernel, step by step as the JAX
    package's ``dense_int8``: row codes, the exact int32 product (an fp64
    matmul of the codes), ``acc * s_x * s_w (+ bias)`` in fp32, rounded to
    x's dtype."""
    K, N = kernel_q.shape
    lead = x.shape[:-1]
    q, s = quantize_rows(x.reshape(-1, K))
    return _dequant_plain(q, s, kernel_q, w_scale, bias, x.dtype).reshape(*lead, N)


def _check_args(x, kernel_q, w_scale, bias) -> Tuple[int, int]:
    """(K, N), checked against every argument."""
    if kernel_q.dim() != 2 or kernel_q.dtype != torch.int8:
        raise ValueError(f"kernel_q must be a 2-D int8 (K, N) tensor, got "
                         f"{kernel_q.dtype} {tuple(kernel_q.shape)}")
    K, N = kernel_q.shape
    if x.shape[-1] != K:
        raise ValueError(f"x (..., {x.shape[-1]}) does not match kernel_q ({K}, {N})")
    if K < 1 or N < 1:
        raise ValueError(f"dense_int8 takes K >= 1 and N >= 1, got K={K}, N={N}")
    for name, t in (("scale", w_scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be ({N},), got {tuple(t.shape)}")
    return K, N


def _rows(x: torch.Tensor, K: int) -> torch.Tensor:
    """x as (M, Kp) rows with a unit column stride and 16-byte aligned
    rows, the columns past K zero: a view where K is a multiple of 16 and
    x already is one, else a copy (zero-padded at a ragged K)."""
    x2 = x.reshape(-1, K)
    if K % K_MULTIPLE:
        return _pad_to(x2, padded_k(K))
    if (x2.stride(1) != 1 or x2.stride(0) < K or (x2.stride(0) * x2.element_size()) % 16
            or x2.data_ptr() % 16):
        x2 = x2.contiguous()
    return x2


def _gemm_operands(kernel_q, w_scale, bias):
    """W^T (N, K) with rows of Kp codes (a view of ``kernel_q`` in
    :func:`k_major`'s layout, as :func:`quantized_to` stores it on the
    card, else such a copy for the call), and s_w and the bias in fp32."""
    wt = k_major(kernel_q).t()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    return wt, w_scale.to(torch.float32).contiguous(), b


def _cuda_args(x, *tensors):
    """Raise unless x is fp32 or bf16 on the card with the other tensors."""
    if x.device.type != "cuda":
        raise ValueError(f"dense_int8: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dense_int8: unsupported dtype {x.dtype}")
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError("dense_int8: tensors on different devices")


def _scratch(M: int, K: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pass's outputs: codes (M, Kp) int8 and scales (M,) fp32."""
    return (torch.empty((M, padded_k(K)), dtype=torch.int8, device=device),
            torch.empty((M,), dtype=torch.float32, device=device))


def _out(M: int, N: int, dtype, device) -> torch.Tensor:
    """y (M, N) with rows padded to 16 bytes (TMA's row stride): the
    kernel writes columns < N only; :func:`_unpad` drops the rest."""
    per = 16 // (torch.finfo(dtype).bits // 8)
    return torch.empty((M, -(-N // per) * per), dtype=dtype, device=device)


def _unpad(out: torch.Tensor, N: int) -> torch.Tensor:
    return out if out.shape[1] == N else out[:, :N].contiguous()


def dense_int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's first launch alone: codes (M, K) int8 and scales (M,)
    fp32 of x (..., K) flattened to rows (on the card a view of the
    pass's (M, Kp) codes).  A CPU tensor takes :func:`quantize_rows`.  Not
    counted: the checks and timings of the pass use it, the engines call
    :func:`dense_int8_fused`."""
    K = x.shape[-1]
    if x.device.type == "cpu":
        q, s = quantize_rows(x.reshape(-1, K))
        return q, s.reshape(-1)
    _cuda_args(x)
    if K < 1:
        raise ValueError(f"dense_int8 takes K >= 1, got K={K}")
    x2 = _rows(x, K)
    M = x2.shape[0]
    q, s = _scratch(M, K, x.device)
    if M:
        lib = _build.load("dense_int8", _SIGNATURES)
        _build.check(lib.dense_int8_quantize(
            _DTYPES[x.dtype], _build.ptr(x2), x2.stride(0), _build.ptr(q), _build.ptr(s), M,
            padded_k(K), _build.stream(x.device)), "dense_int8_quantize")
    return q[:, :K], s


def _padded_codes(q: torch.Tensor, K: int) -> torch.Tensor:
    """Codes q (M, K) as rows Kp apart with a unit column stride (a view of
    :func:`dense_int8_quantize`'s codes as they lie, else a zero-padded
    copy)."""
    if (q.stride(-1) == 1 and q.stride(0) == padded_k(K) and q.data_ptr() % 16 == 0):
        return q
    return _pad_to(q.contiguous(), padded_k(K))


def dense_int8_gemm(q, s, kernel_q, w_scale, bias=None, dtype=torch.bfloat16):
    """The kernel's second launch alone: y (M, N) in ``dtype`` from the
    codes q (M, K) and scales s (M,) of :func:`dense_int8_quantize`.  A
    CPU tensor takes the plain product and epilogue.  Not counted."""
    K, N = kernel_q.shape
    if q.device.type == "cpu":
        return _dequant_plain(q, s.reshape(-1, 1), kernel_q, w_scale, bias, dtype)
    wt, sw, b = _gemm_operands(kernel_q, w_scale, bias)
    M = q.shape[0]
    qp = _padded_codes(q, K)
    out = _out(M, N, dtype, q.device)
    if M:
        lib = _build.load("dense_int8", _SIGNATURES)
        _build.check(lib.dense_int8_gemm(
            _DTYPES[dtype], _build.ptr(qp), _build.ptr(s), _build.ptr(wt), wt.stride(0),
            _build.ptr(sw), _build.ptr(b), _build.ptr(out), out.stride(0), M, K, N,
            _build.stream(q.device)), "dense_int8_gemm")
    return _unpad(out, N)


def dense_int8_fused(
    x: torch.Tensor,               # (..., K) fp32 or bf16
    kernel_q: torch.Tensor,        # (K, N) int8
    w_scale: torch.Tensor,         # (N,) fp32
    bias: Optional[torch.Tensor] = None,   # (N,) or None
) -> torch.Tensor:
    """y = dequant(quant_rows(x) @ kernel_q) + bias, (..., N) in x's dtype.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel, the row-quantize pass and the GEMM from one call (or
    raises).  x may be a strided view whose rows have a unit column
    stride (the [CLS] rows ``x[:, :1]``).  ``kernel_q`` is read without a
    copy when it is column-major (:func:`quantized_to`)."""
    K, N = _check_args(x, kernel_q, w_scale, bias)
    if x.device.type == "cpu":
        return dense_int8_fused_plain(x, kernel_q, w_scale, bias)
    _cuda_args(x, kernel_q, w_scale, bias)
    lead = x.shape[:-1]
    x2 = _rows(x, K)
    wt, sw, b = _gemm_operands(kernel_q, w_scale, bias)
    M = x2.shape[0]
    out = _out(M, N, x.dtype, x.device)
    if M:
        q, s = _scratch(M, K, x.device)
        lib = _build.load("dense_int8", _SIGNATURES)
        status = lib.dense_int8(
            _DTYPES[x.dtype], _build.ptr(x2), x2.stride(0), _build.ptr(q), _build.ptr(s),
            _build.ptr(wt), wt.stride(0), _build.ptr(sw), _build.ptr(b), _build.ptr(out),
            out.stride(0), M, K, N, _build.stream(x.device))
        _build.check(status, "dense_int8")
        dense_int8_fused.launches += 1
    return _unpad(out, N).reshape(*lead, N)


dense_int8_fused.launches = 0


def dense_int8(x: torch.Tensor, p: Mapping) -> torch.Tensor:
    """The dense of a quantized leaf ``{"kernel_q", "scale"[, "bias"]}``:
    a CPU tensor takes the plain version, a CUDA tensor the kernel."""
    return dense_int8_fused(x, p["kernel_q"], p["scale"], p.get("bias"))
