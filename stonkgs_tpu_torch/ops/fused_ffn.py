"""The BERT FFN on the card: the serving block and the training pair.

Serving: LN1 -> FFN -> LN2 of a post-LN layer
=============================================

Kernel: ``csrc/ffn_ln_block.cu`` (CUDA C++ for ``sm_90a``).  It replaces
the TPU kernel ``_ffn_ln_kernel`` of the JAX package
(``stonkgs_tpu/ops/fused_ffn.py:438``, launched by ``_fused_block_call``
at ``:618``).

What bounds it on the H100: at the path's shapes (M = 32,768 or 65,536
rows, 768 -> 3072 -> 768) the two products are 4*M*768*3072 operations
against (3*M*768 + 2*768*3072) bytes, about 2,000 operations a byte, far
above the card's ~295 bf16 operations per byte of device memory: the
kernel is bound by operations (0.63 ms at M = 65,536 at the 989 TFLOP/s
bf16 peak).

Design: the TPU kernel keeps a whole (512, 3072) intermediate and both
weight matrices in ~48 MB of VMEM.  A Hopper block has 227 KB of shared
memory and 64K registers.  The first version of the port fused the
block into one kernel: a block of 48 rows kept its fp32 (48, 768) accumulator in
registers while it walked the intermediate axis, re-streaming both
weight matrices from L2 for every 48 rows on ``mma.sync`` (5.4 ms at
M = 65,536 on an H100 SXM at 700 W, 3.7x the two cuBLAS products it
contains).  The accumulator caps the row tile: 128 x 768 in fp32 is more
than the whole register file.  So bf16 runs the Hopper design of
``csrc/ffn_sm90.cuh``, four launches that keep the TPU kernel's rounding
points: LN1 over x + attn into a bf16 scratch x2; a ``wgmma`` GEMM x2 @ W1
with a b1 + gelu epilogue into a bf16 scratch h (M, I); a ``wgmma`` GEMM
h @ W2 with a b2 epilogue into ``out``; LN2 over x2 + ff in place.  h
makes a round trip through device memory (402 MB at the trunk's shape,
~0.24 ms of HBM time) that the products, bound by operations, hide.  The
GEMM takes a 128 x 256 tile of C a block: a producer warpgroup streams
the K axis in 64-deep steps through a 4-stage TMA ring (A K-major, the
(K, N) row-major weight read MN-major as it lies, no transposed copy),
two consumer warpgroups run ``wgmma.m64n256k16`` into 128 fp32
registers each, and the epilogue adds the bias, applies gelu (erf) or
``gelu_new`` (tanh) in fp32 and stores bf16 pairs; TMA zero-fills a
ragged M, N or K edge.  The epilogue is the GEMM's second cost at K = 768
(it does not overlap the products), so it is written without branches:
erf and tanh are evaluated branch-free (``gelu_sel``: erf within 1.3 ulp
of the true erf in fp32, as against 2 ulp for CUDA's ``erff``) and only
the stores are guarded, so its 128 values a thread interleave.  The
LayerNorm passes take a warp a row, its H/32 values a lane in registers,
with the widest vector loads H allows (16 bytes when H is a multiple of
256).  The fp32 instantiation keeps the fused kernel (``ffn_fwd_kernel``
of ``csrc/ffn.cuh``, 16-row blocks of plain fp32 FMAs, 256 threads, the
intermediate axis in chunks of 128 and the widths as run-time
arguments): it exists to hold the whole model against the CPU.

Widths (:func:`ffn_kernel_takes`): every FFN kernel, in both dtypes,
takes any hidden width H >= 1 and any intermediate width I >= 1, as the
JAX package runs every width (it falls back to XLA where its Pallas
kernels do not fit; the port has no fallback): 768 in BERT-base, BioBERT
and the BigBird trunk, 1024 in ProtBERT, 384 in MiniLM-L12-H384, and the
KG vectors' width in the command line's configs (4, 8, 48, 100, 1280, 2560, ...
at I = 4H; 2,560 with I = 10,240 is Megatron-BERT 3.9B's).  The C entry points
take the true widths and arrays in a padded layout, each row of H (or I)
values ``padded_width`` elements long: a multiple of 8 in bf16 (TMA's
16-byte strides; the tensor maps take the true width, so TMA zero-fills
past it and nothing reads the padding), of 32 in fp32 (the SIMT bodies
run at the padded widths on zero padding).  The wrappers pad a width that
is not such a multiple with zeros and slice the outputs back; at H = 768,
1024, 384 and every multiple of 8 in bf16 nothing is copied; below 8 (H
= 4 from a 4-wide KG TSV) a bf16 row of 8 bytes is copied into a row of
16, as TMA's strides are multiples of 16 bytes.  The
LayerNorm passes take their statistics over the true H; a bf16 pass holds
a row in registers up to H = 2048 and walks it in 16-byte chunks above
(sum, centred sum of squares over a second read from L2, normalise), as a
lane would otherwise hold 80 values at H = 2,560 and spill.  The fused
fp32 bodies have two instances, the original one up to a padded H of 1024
and one with 8-row blocks up to 2048 (``csrc/ffn.cuh``); above 2048 their
(rows, H) accumulator and row operands leave no room, so fp32 is split at
h as bf16 is (a chunked LayerNorm pass, a tiled SIMT GEMM with the bias
and gelu in its epilogue into an fp32 scratch h, a second GEMM, the
LayerNorm in place; the backward three such GEMMs).  At ProtBERT's serving
shape (M = 8·3072 = 24,576 rows) the products are 4·M·1024·4096 = 412
GFLOP, bound by operations (0.42 ms at 989 TFLOP/s).

Rounding points, as the TPU kernel (``fused_ffn.py:444-467``):
x2 = LN1(x + attn) in fp32, rounded; h accumulated in fp32, + b1, gelu in
fp32 (exact erf, or the tanh ``gelu_new``), rounded; ff = h @ W2 + b2,
rounded; out = LN2(x2 + ff) in fp32, rounded.

Training: dense -> gelu -> dense, forward and backward
======================================================

Kernels: ``csrc/ffn_train.cu``, two entry points.  They replace
``_ffn_kernel`` (``stonkgs_tpu/ops/fused_ffn.py:54``, launched at
``:153``) and ``_ffn_bwd_kernel`` (``:206``, launched at ``:306``).

What bounds them on the H100, at the pre-training step's trunk shape
(M = 32·512 = 16,384 rows, 768 -> 3072 -> 768, bf16), counting each input
byte once and each output byte once:

* forward: 4*M*768*3072 = 154.6 GFLOP against 59.8 MB (x, y, both
  weights): bound by operations, 0.156 ms at 989 TFLOP/s;
* backward: 6*M*768*3072 = 231.9 GFLOP (h recomputed, g W2ᵀ, dh W1ᵀ)
  against 286 MB (x, g and dx; the (M, 3072) dh and a it writes; W1 and
  W2): bound by operations, 0.234 ms.  The dW products, another
  4*M*768*3072, run outside it.

Design.  The TPU kernels keep a whole row block's (bm, 3072) fp32
intermediate and both weight matrices in VMEM.  On a Hopper block the
same fused shape keeps a (rows, H) fp32 accumulator in registers, which
caps the row tile at 32-48 rows, and re-streams both weight matrices
from L2 for every row block (9-14× the bound forward, 10.7× backward,
on ``mma.sync`` in the port's first version).  So bf16 runs the Hopper
kernels of ``csrc/ffn_train_sm90.cuh``, GEMMs at a 128-row tile with TMA
rings and ``wgmma``, each weight read as it lies (no transposed copy):

* forward: the serving block's two GEMMs without its LayerNorms,
  x W1 + b1 -> gelu -> round into a bf16 scratch h (M, I), then h W2 + b2
  -> round; h's round trip through device memory (100 MB at the trunk's
  shape) is hidden by the products;
* backward, two launches: a dual GEMM over 128 x 128 tiles of (M, I)
  forms both x W1 (W1 MN-major) and g W2ᵀ (W2 as the K-major B operand)
  from one TMA ring over K = H, each of two consumer warpgroups holding
  both fp32 accumulators of its 64 rows; its epilogue adds b1, computes
  gelu and gelu' together without branches and stores a and dh, so h
  never leaves registers; then dx = dh W1ᵀ with W1 (H, I) as the K-major
  B operand.

The widths and the padded layout are the serving block's.  fp32 keeps
the SIMT bodies of ``csrc/ffn.cuh`` and ``csrc/ffn_train.cu`` (the
backward streams W2ᵀ and W1ᵀ copies that the wrapper makes): they exist
to hold the model against the CPU.  dW1 = xᵀ dh, dW2 = aᵀ g (fp32
results of bf16 products) and the bias sums stay
plain PyTorch, as the JAX package leaves them to XLA
(``fused_ffn.py:334-341``).  Rounding points as the TPU kernels: g cast
to x's dtype; h, gelu and gelu' in fp32; a rounded; dh = (g W2ᵀ) ⊙
gelu'(h) rounded before the dx product (``fused_ffn.py:243``).  The
port computes gelu with the exact erf (the JAX kernel's
Abramowitz-Stegun erf was a Mosaic workaround).
"""

from __future__ import annotations

import math

import torch

from stonkgs_tpu_torch.ops import _build
from stonkgs_tpu_torch.ops.flash_attention import _unpad

_ACTS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the FFN kernels' widths: any H and I from FFN_MIN_WIDTH up
FFN_MIN_WIDTH = 1
# the widest padded H of the fused fp32 bodies (csrc/ffn.cuh, kRowHidden):
# above it the fp32 path is split at h and takes scratch as bf16 does
FFN_FUSED_MAX_HIDDEN = 2048
# the padded layout's row multiple in each dtype (csrc/ffn.cuh, padded_width)
_ROW_MULTIPLE = {torch.float32: 32, torch.bfloat16: 8}
_P, _I, _F = _build.P, _build.I32, _build.F32
# int ffn_ln_block(dtype, x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2,
#                  ln2_scale, ln2_bias, x2, h, out, M, H, I, act, eps, stream)
_SIGNATURES = {"ffn_ln_block": [_I] + [_P] * 13 + [_I, _I, _I, _I, _F, _P]}
_TRAIN_SIGNATURES = {
    # int ffn_train_fwd(dtype, x, w1, b1, w2, b2, h, out, M, H, I, act, stream)
    "ffn_train_fwd": [_I] + [_P] * 7 + [_I, _I, _I, _I, _P],
    # int ffn_train_bwd(dtype, x, g, w1, b1, w2, w2t, w1t, dx, dh, a, M, H, I,
    #                   act, stream)
    "ffn_train_bwd": [_I] + [_P] * 10 + [_I, _I, _I, _I, _P],
}
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _layer_norm_rows(y32, scale, bias, eps):
    m = y32.mean(dim=-1, keepdim=True)
    v = (y32 - m).square().mean(dim=-1, keepdim=True)
    return (y32 - m) * torch.rsqrt(v + eps) * scale.float() + bias.float()


def _gelu(h32: torch.Tensor, act: str) -> torch.Tensor:
    """Exact-erf gelu ("gelu") or the tanh form ("gelu_new"), in fp32."""
    if act == "gelu":
        return 0.5 * h32 * (1.0 + torch.erf(h32 * (2.0 ** -0.5)))
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * h32 * (1.0 + torch.tanh(c * (h32 + 0.044715 * h32 * h32 * h32)))


def _gelu_and_grad(h32: torch.Tensor, act: str):
    """gelu(h) and gelu'(h) in fp32, as the backward kernels compute them."""
    if act == "gelu":
        e = torch.erf(h32 * _INV_SQRT2)
        return (0.5 * h32 * (1.0 + e),
                0.5 * (1.0 + e) + h32 * _INV_SQRT_2PI * torch.exp(-0.5 * h32 * h32))
    c = math.sqrt(2.0 / math.pi)
    u = torch.tanh(c * (h32 + 0.044715 * h32 * h32 * h32))
    return (0.5 * h32 * (1.0 + u),
            0.5 * (1.0 + u) + 0.5 * h32 * (1.0 - u * u) * c
            * (1.0 + 3 * 0.044715 * h32 * h32))


def _check_act(act: str) -> None:
    if act not in _ACTS:
        raise ValueError(f"unsupported activation for the fused FFN: {act}")


def ffn_kernel_takes(H: int, I: int) -> bool:
    """Whether the card's FFN kernels (the serving block, the training
    forward and backward, in fp32 and bf16) take hidden width ``H`` and
    intermediate width ``I``: any H and I from 1 up."""
    return H >= FFN_MIN_WIDTH and I >= FFN_MIN_WIDTH


def check_ffn_widths(what: str, H: int, I: int) -> None:
    """Raise unless the FFN kernels take widths ``H`` and ``I``
    (:func:`ffn_kernel_takes`)."""
    if not ffn_kernel_takes(H, I):
        raise ValueError(f"{what} kernel takes H and I from {FFN_MIN_WIDTH} up, "
                         f"got H={H}, I={I}")


def padded_width(n: int, dtype) -> int:
    """The row length of an ``n``-wide array in the kernels' padded layout:
    ``n`` rounded up to a multiple of 32 in fp32, of 8 in bf16."""
    m = _ROW_MULTIPLE[dtype]
    return -(-n // m) * m


def _scratch(M: int, Hp: int, Ip: int, dt, device, with_x2: bool):
    """The kernels' scratch, x2 (M, Hp) (``with_x2``) and h (M, Ip) in
    ``dt``, where the path takes it (bf16, and fp32 above a padded H of
    :data:`FFN_FUSED_MAX_HIDDEN`), else None."""
    if dt == torch.float32 and Hp <= FFN_FUSED_MAX_HIDDEN:
        return None, None
    h = torch.empty((M, Ip), dtype=dt, device=device)
    return (torch.empty((M, Hp), dtype=dt, device=device) if with_x2 else None), h


def _pad_to(t: torch.Tensor, *widths):
    """``t`` with its last ``len(widths)`` axes zero-padded to ``widths``
    (``t`` itself where they already are)."""
    pad = []
    for size, width in zip(reversed(t.shape[-len(widths):]), reversed(widths)):
        pad += [0, width - size]
    return torch.nn.functional.pad(t, pad) if any(pad) else t


def _check_cuda_ffn(what: str, x, w1, w2, *tensors) -> None:
    """Raise unless x (..., H) and the weights suit the kernels
    (:func:`check_ffn_widths`) and every tensor is contiguous on x's CUDA
    device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    H = x.shape[-1]
    I = w1.shape[-1]
    check_ffn_widths(what, H, I)
    if tuple(w1.shape) != (H, I) or tuple(w2.shape) != (I, H):
        raise ValueError(f"weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}"
                         f" do not match H={H}, I={I}")
    for t in (x, w1, w2, *tensors):
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def fused_ffn_ln_block_plain(x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2,
                             ln2_scale, ln2_bias, *, act="gelu", eps=1e-12):
    """Plain PyTorch version of the kernel: the same function, the same
    rounding points, products in fp32 on operands of the input dtype."""
    dt = x.dtype
    f = torch.float32
    x2 = _layer_norm_rows(x.to(f) + attn_out.to(dt).to(f),
                          ln1_scale, ln1_bias, eps).to(dt)
    h = x2.to(f) @ w1.to(dt).to(f) + b1.to(f)
    h = _gelu(h, act).to(dt)
    ff = (h.to(f) @ w2.to(dt).to(f) + b2.to(f)).to(dt)
    return _layer_norm_rows(x2.to(f) + ff.to(f), ln2_scale, ln2_bias,
                            eps).to(dt)


def fused_ffn_ln_block(
    x: torch.Tensor,          # (..., H) layer input (pre-attention residual)
    attn_out: torch.Tensor,   # (..., H) attention output-projection result
    ln1_scale, ln1_bias,      # post-attention LayerNorm (H,)
    w1, b1,                   # intermediate dense (H, I), (I,)
    w2, b2,                   # output dense (I, H), (H,)
    ln2_scale, ln2_bias,      # post-FFN LayerNorm (H,)
    *,
    act: str = "gelu",
    eps: float = 1e-12,
) -> torch.Tensor:
    """LN1(x + attn) -> dense -> gelu -> dense -> LN2(x2 + ff).

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises).  Weights are used in ``x.dtype`` and the
    LayerNorm and bias vectors in fp32, as the TPU kernel reads them."""
    _check_act(act)
    if x.device.type == "cpu":
        return fused_ffn_ln_block_plain(
            x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2,
            ln2_scale, ln2_bias, act=act, eps=eps)
    dt = x.dtype
    w1 = w1.to(dt)
    w2 = w2.to(dt)
    vecs = [t.float() for t in (ln1_scale, ln1_bias, b1, b2,
                                ln2_scale, ln2_bias)]
    _check_cuda_ffn("fused_ffn_ln_block", x, w1, w2, attn_out, *vecs)
    if attn_out.shape != x.shape or attn_out.dtype != dt:
        raise ValueError("attn_out must match x in shape and dtype")
    H, I = w1.shape
    for t, n in zip(vecs, (H, H, I, H, H, H)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"vector of shape {tuple(t.shape)}, expected ({n},)")
    M = x.numel() // H
    Hp, Ip = padded_width(H, dt), padded_width(I, dt)
    # the padded layout: rows of Hp and Ip elements, zero past H and I
    xp, ap = (_pad_to(t.reshape(M, H), Hp) for t in (x, attn_out))
    w1, w2 = _pad_to(w1, Hp, Ip), _pad_to(w2, Ip, Hp)
    g1, be1, b1f, b2f, g2, be2 = (_pad_to(t, n) for t, n in
                                  zip(vecs, (Hp, Hp, Ip, Hp, Hp, Hp)))
    out = torch.empty((M, Hp), dtype=dt, device=x.device)
    # scratch of the split path: x2 = LN1(x + attn) and h (M, I)
    x2, h = _scratch(M, Hp, Ip, dt, x.device, True)
    _build.check_aligned("fused_ffn_ln_block", xp, ap, w1, w2, x2, h, out)
    if M == 0:
        return _unpad(H, out)[0].reshape(x.shape)
    lib = _build.load("ffn_ln_block", _SIGNATURES)
    status = lib.ffn_ln_block(
        _DTYPES[dt], _build.ptr(xp), _build.ptr(ap),
        _build.ptr(g1), _build.ptr(be1), _build.ptr(w1), _build.ptr(b1f),
        _build.ptr(w2), _build.ptr(b2f), _build.ptr(g2), _build.ptr(be2),
        _build.ptr(x2), _build.ptr(h), _build.ptr(out), M, H, I, _ACTS[act],
        float(eps), _build.stream(x.device))
    _build.check(status, "ffn_ln_block")
    fused_ffn_ln_block.launches += 1
    return _unpad(H, out)[0].reshape(x.shape)


fused_ffn_ln_block.launches = 0


# ---------------------------------------------------------------------------
# training: dense -> gelu -> dense, forward and backward
# ---------------------------------------------------------------------------

def fused_ffn_plain(x, w1, b1, w2, b2, *, act="gelu"):
    """Plain PyTorch version of the training forward kernel: h = x W1 + b1
    in fp32 from products of x's dtype, gelu in fp32, rounded; y = h W2 +
    b2 in fp32, rounded."""
    dt = x.dtype
    f = torch.float32
    h = _gelu(x.to(f) @ w1.to(dt).to(f) + b1.to(f), act).to(dt)
    return (h.to(f) @ w2.to(dt).to(f) + b2.to(f)).to(dt)


def fused_ffn_bwd_plain(x, g, w1, b1, w2, *, act="gelu"):
    """Plain PyTorch version of the backward kernel, on (M, H) rows.

    Returns (dx, dh, a) in x's dtype: h = x W1 + b1 recomputed in fp32;
    a = gelu(h) rounded; dh = (g W2ᵀ) ⊙ gelu'(h) in fp32, rounded;
    dx = dh W1ᵀ in fp32, rounded.  ``g`` is used in x's dtype."""
    dt = x.dtype
    f = torch.float32
    w1f = w1.to(dt).to(f)
    a32, dact = _gelu_and_grad(x.to(f) @ w1f + b1.to(f), act)
    dh = ((g.to(dt).to(f) @ w2.to(dt).to(f).T) * dact).to(dt)
    dx = (dh.to(f) @ w1f.T).to(dt)
    return dx, dh, a32.to(dt)


def fused_ffn_fwd(x, w1, b1, w2, b2, *, act="gelu"):
    """Training forward, y = gelu(x W1 + b1) W2 + b2 over x (..., H).

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    _check_act(act)
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2, act=act)
    dt = x.dtype
    w1, w2 = w1.to(dt), w2.to(dt)
    b1f, b2f = b1.float(), b2.float()
    _check_cuda_ffn("fused_ffn_fwd", x, w1, w2, b1f, b2f)
    H, I = w1.shape
    M = x.numel() // H
    Hp, Ip = padded_width(H, dt), padded_width(I, dt)
    xp = _pad_to(x.reshape(M, H), Hp)
    w1, w2 = _pad_to(w1, Hp, Ip), _pad_to(w2, Ip, Hp)
    b1f, b2f = _pad_to(b1f, Ip), _pad_to(b2f, Hp)
    out = torch.empty((M, Hp), dtype=dt, device=x.device)
    # scratch of the split path: h (M, I)
    h = _scratch(M, Hp, Ip, dt, x.device, False)[1]
    _build.check_aligned("fused_ffn_fwd", xp, w1, w2, h, out)
    if M == 0:
        return _unpad(H, out)[0].reshape(x.shape)
    lib = _build.load("ffn_train", _TRAIN_SIGNATURES)
    status = lib.ffn_train_fwd(
        _DTYPES[dt], _build.ptr(xp), _build.ptr(w1), _build.ptr(b1f), _build.ptr(w2),
        _build.ptr(b2f), _build.ptr(h), _build.ptr(out), M, H, I, _ACTS[act],
        _build.stream(x.device))
    _build.check(status, "ffn_train_fwd")
    fused_ffn_fwd.launches += 1
    return _unpad(H, out)[0].reshape(x.shape)


fused_ffn_fwd.launches = 0


def fused_ffn_bwd(x, g, w1, b1, w2, *, act="gelu"):
    """Backward of the training FFN's activation side over (M, H) rows:
    (dx, dh, a), as :func:`fused_ffn_bwd_plain`; ``g`` in x's dtype.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    _check_act(act)
    if x.device.type == "cpu":
        return fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)
    dt = x.dtype
    w1, w2 = w1.to(dt), w2.to(dt)
    b1f = b1.float()
    _check_cuda_ffn("fused_ffn_bwd", x, w1, w2, g, b1f)
    if x.dim() != 2 or g.shape != x.shape or g.dtype != dt:
        raise ValueError("fused_ffn_bwd takes x and g as (M, H) in one dtype")
    M, (H, I) = x.shape[0], w1.shape
    Hp, Ip = padded_width(H, dt), padded_width(I, dt)
    xp, gp = _pad_to(x, Hp), _pad_to(g, Hp)
    w1, w2, b1f = _pad_to(w1, Hp, Ip), _pad_to(w2, Ip, Hp), _pad_to(b1f, Ip)
    # fp32: the SIMT body streams W2ᵀ and W1ᵀ copies; the bf16 GEMMs read
    # both weights as they lie
    w2t, w1t = ((w2.t().contiguous(), w1.t().contiguous())
                if dt == torch.float32 else (None, None))
    dx = torch.empty((M, Hp), dtype=dt, device=x.device)
    dh = torch.empty((M, Ip), dtype=dt, device=x.device)
    a = torch.empty((M, Ip), dtype=dt, device=x.device)
    _build.check_aligned("fused_ffn_bwd", xp, gp, w1, w2, w2t, w1t, dx, dh, a)
    if M == 0:
        return (*_unpad(H, dx), *_unpad(I, dh, a))
    lib = _build.load("ffn_train", _TRAIN_SIGNATURES)
    status = lib.ffn_train_bwd(
        _DTYPES[dt], _build.ptr(xp), _build.ptr(gp), _build.ptr(w1), _build.ptr(b1f),
        _build.ptr(w2), _build.ptr(w2t), _build.ptr(w1t), _build.ptr(dx), _build.ptr(dh),
        _build.ptr(a), M, H, I, _ACTS[act], _build.stream(x.device))
    _build.check(status, "ffn_train_bwd")
    fused_ffn_bwd.launches += 1
    return (*_unpad(H, dx), *_unpad(I, dh, a))


fused_ffn_bwd.launches = 0


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as fp32 sums of products of the inputs' dtype (the JAX
    package's ``preferred_element_type=f32``)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedFFN(torch.autograd.Function):
    """The training FFN pair as one autograd function; it saves what the
    JAX custom VJP saves, the inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.act = act
        return fused_ffn_fwd(x, w1, b1, w2, b2, act=act)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        H = x.shape[-1]
        x2 = x.reshape(-1, H)
        g2 = g.reshape(-1, H).to(x.dtype).contiguous()
        dx, dh, a = fused_ffn_bwd(x2, g2, w1, b1, w2, act=ctx.act)
        dw1 = _matmul_f32(x2.t(), dh)
        dw2 = _matmul_f32(a.t(), g2)
        db1 = dh.float().sum(dim=0)
        db2 = g2.float().sum(dim=0)
        return (dx.reshape(x.shape), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None)


def fused_ffn(
    x: torch.Tensor,   # (..., H)
    w1: torch.Tensor,  # (H, I)
    b1: torch.Tensor,  # (I,)
    w2: torch.Tensor,  # (I, H)
    b2: torch.Tensor,  # (H,)
    *,
    act: str = "gelu",
) -> torch.Tensor:
    """dense(H->I) -> gelu/gelu_new -> dense(I->H), differentiable.

    The forward and the backward's activation side are kernels; the
    (M, I) intermediate is recomputed in the backward, never saved."""
    _check_act(act)
    return _FusedFFN.apply(x, w1, b1, w2, b2, act)
