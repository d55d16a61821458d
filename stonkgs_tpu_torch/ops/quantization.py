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

``csrc/dense_int8.cu`` (CUDA C++ for ``sm_90a``).  It replaces the TPU
kernel ``_fused_kernel`` (``stonkgs_tpu/ops/quantization_pallas.py:33``,
launched at ``:77``).  The TPU wrapper's gate (``supported``: K and N
multiples of 128, W under 8 MB of VMEM) and its padding of M to 256 rows
are Mosaic needs and are not copied: the kernel takes every leaf that
:func:`quantize_params` makes, the decoders (N = 28,996 and 100,000)
included, for any M, any N >= 1 and K a multiple of 16.

What bounds it on the H100 (each input byte once, each output byte once;
x and y bf16, W int8; 3.35 TB/s and 1,979 int8 TOP/s): at M = 65,536 the
768 -> 768 projections move 201.9 MB for 77 GOP (0.060 ms, bytes); the
768 -> 3072 and 3072 -> 768 products are 309 GOP (0.156 ms, operations).

Design.  The TPU kernel keeps the whole (K, N) weight in VMEM and takes
256 rows at a time.  A Hopper block owns a 128 x 128 output tile and runs
in three steps:

1. the absmax of each of its 128 rows over the whole K (read through L2),
   whose scale ``max(absmax / 127, 1e-12)`` goes to shared memory;
2. a loop over K in steps of 64: the x tile is loaded into registers one
   step ahead, quantized against its row's scale into an int8 shared
   tile, the int8 W tile (128 columns) beside it, and the int8 tensor
   cores (``nvcuda::wmma`` 16 x 16 x 16 on ``signed char``) accumulate in
   int32 registers, two shared buffers in turn;
3. the epilogue ``acc * s_x * s_w + b`` in fp32, each product rounded
   (``__fmul_rn``, ``__fadd_rn``: no fused multiply-add), rounded once to
   x's dtype.

Every block of a row tile quantizes the same rows again (N / 128 times):
the price of one kernel without an int8 copy of x in device memory.
``wgmma``, TMA and a W kept resident belong to later work.

Rounding, as the TPU kernel and the XLA path: the scale is an IEEE fp32
division by 127 floored at 1e-12; a code is ``clip(rint(x / s), -127,
127)`` with an IEEE division and round-half-to-even, never a reciprocal
and never ``roundf``; ``-use_fast_math`` stays out of the build flags.
The int32 sums cannot overflow (127^2 * 4,096 ~ 6.6e7).

The plain version computes the int32 product as an fp64 matmul of the
codes: exact while |acc| < 2^53, on the CPU and on the card alike (CUDA
PyTorch has no int32 matmul).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from stonkgs_tpu_torch.ops import _build

# dense kernels are quantized when both dims are at least this (skips tiny
# projections where quantization costs more than it saves)
MIN_QUANT_DIM = 64
SKIP_KEYS = ("pooler",)   # the tanh pooler is scale-sensitive
K_MULTIPLE = 16           # the kernel's K step of its tensor-core products
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = _build.P, _build.I32, _build.I64
# int dense_int8(dtype, x, ldx, w, w_scale, bias, out, M, K, N, stream)
_SIGNATURES = {"dense_int8": [_I, _P, _L, _P, _P, _P, _P, _I, _I, _I, _P]}


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


def quantized_to(p: Mapping, device=None) -> dict:
    """A quantized dense moved to ``device``, every leaf in its own dtype:
    :func:`dense_int8` reads the scale and the bias in fp32 whatever the
    compute dtype."""
    return {k: v.to(device) for k, v in p.items()}


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes of x (..., K) and their fp32 scales (..., 1)."""
    xf = x.to(torch.float32)
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return _codes(xf, scale), scale


def dense_int8_fused_plain(x, kernel_q, w_scale, bias=None):
    """Plain PyTorch version of the kernel, step by step as the JAX
    package's ``dense_int8``: row codes, the exact int32 product (an fp64
    matmul of the codes), ``acc * s_x * s_w (+ bias)`` in fp32, rounded to
    x's dtype."""
    K, N = kernel_q.shape
    lead = x.shape[:-1]
    q, s = quantize_rows(x.reshape(-1, K))
    acc = (q.double() @ kernel_q.double()).to(torch.float32)
    y = acc * s * w_scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype).reshape(*lead, N)


def _check_args(x, kernel_q, w_scale, bias) -> Tuple[int, int]:
    """(K, N), checked against every argument."""
    if kernel_q.dim() != 2 or kernel_q.dtype != torch.int8:
        raise ValueError(f"kernel_q must be a 2-D int8 (K, N) tensor, got "
                         f"{kernel_q.dtype} {tuple(kernel_q.shape)}")
    K, N = kernel_q.shape
    if x.shape[-1] != K:
        raise ValueError(f"x (..., {x.shape[-1]}) does not match kernel_q ({K}, {N})")
    if K % K_MULTIPLE or N < 1:
        raise ValueError(f"dense_int8 takes K a multiple of {K_MULTIPLE} and N >= 1, "
                         f"got K={K}, N={N}")
    for name, t in (("scale", w_scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be ({N},), got {tuple(t.shape)}")
    return K, N


def _rows(x: torch.Tensor, K: int) -> torch.Tensor:
    """x as (M, K) rows with a unit column stride and 16-byte aligned rows
    (a view where it already is one, else a copy)."""
    x2 = x.reshape(-1, K)
    if (x2.stride(1) != 1 or x2.stride(0) < K or (x2.stride(0) * x2.element_size()) % 16
            or x2.data_ptr() % 16):
        x2 = x2.contiguous()
    return x2


def dense_int8_fused(
    x: torch.Tensor,               # (..., K) fp32 or bf16
    kernel_q: torch.Tensor,        # (K, N) int8
    w_scale: torch.Tensor,         # (N,) fp32
    bias: Optional[torch.Tensor] = None,   # (N,) or None
) -> torch.Tensor:
    """y = dequant(quant_rows(x) @ kernel_q) + bias, (..., N) in x's dtype.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises).  x may be a strided view whose rows have a
    unit column stride (the [CLS] rows ``x[:, :1]``)."""
    K, N = _check_args(x, kernel_q, w_scale, bias)
    if x.device.type == "cpu":
        return dense_int8_fused_plain(x, kernel_q, w_scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dense_int8: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dense_int8: unsupported dtype {x.dtype}")
    lead = x.shape[:-1]
    x2 = _rows(x, K)
    w = kernel_q.contiguous()
    sw = w_scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    for t in (w, sw, b):
        if t is not None and t.device != x.device:
            raise ValueError("dense_int8: tensors on different devices")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    lib = _build.load("dense_int8", _SIGNATURES)
    status = lib.dense_int8(
        _DTYPES[x.dtype], _build.ptr(x2), x2.stride(0), _build.ptr(w), _build.ptr(sw),
        _build.ptr(b), _build.ptr(out), M, K, N, _build.stream(x.device))
    _build.check(status, "dense_int8")
    dense_int8_fused.launches += 1
    return out.reshape(*lead, N)


dense_int8_fused.launches = 0


def dense_int8(x: torch.Tensor, p: Mapping) -> torch.Tensor:
    """The dense of a quantized leaf ``{"kernel_q", "scale"[, "bias"]}``:
    a CPU tensor takes the plain version, a CUDA tensor the kernel."""
    return dense_int8_fused(x, p["kernel_q"], p["scale"], p.get("bias"))
