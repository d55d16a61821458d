"""Post-attention half of a post-LN BERT layer: LN1 -> FFN -> LN2, fused.

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
memory, so one block takes 48 rows (bf16; 12 warps) and keeps only their
LN1 output ``x2`` in shared memory.  It walks the intermediate axis in
chunks of 192: h = x2 @ W1[:, chunk] + b1, gelu, rounded to the input
dtype, then ``h @ W2[chunk, :]`` accumulates into an fp32 (48, 768)
accumulator that stays in registers across the whole walk, and LN2 runs
in the epilogue.  Neither ``x2`` nor the (M, 3072) intermediate reaches
device memory.  Both weight matrices (9.4 MB in bf16) stream through the
50 MB L2 as one sequence of tiles in a 3-stage ``cp.async`` ring.  Each
row block re-reads all of them from L2, so the row tile sets the L2
traffic: 48 rows (against 32 in the first version, 6.9 -> 5.3 ms at
M = 65,536 on an H100 SXM at 700 W) is as far as the registers of the
accumulator allow; sharing tiles across a cluster and ``wgmma`` are the
next steps.  bf16 products run on the tensor cores (``nvcuda::wmma``,
fp32 accumulation); the fp32 instantiation runs plain fp32 FMAs on
16-row blocks and exists to hold the whole model against the CPU.

Rounding points, as the TPU kernel (``fused_ffn.py:444-467``):
x2 = LN1(x + attn) in fp32, rounded; h accumulated in fp32, + b1, gelu in
fp32 (exact erf, or the tanh ``gelu_new``), rounded; ff = h @ W2 + b2,
rounded; out = LN2(x2 + ff) in fp32, rounded.
"""

from __future__ import annotations

import math

import torch

from stonkgs_tpu_torch.ops import _build

_ACTS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HIDDEN = 768     # the CUDA tiling is written for BERT-base width
KERNEL_CHUNK = 192      # intermediate-axis chunk; I must be a multiple
_P, _I, _F = _build.P, _build.I32, _build.F32
# int ffn_ln_block(dtype, x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2,
#                  ln2_scale, ln2_bias, out, M, I, act, eps, stream)
_SIGNATURES = {"ffn_ln_block": [_I] + [_P] * 11 + [_I, _I, _I, _F, _P]}


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
    if act not in _ACTS:
        raise ValueError(f"unsupported activation for the fused block: {act}")
    if x.device.type == "cpu":
        return fused_ffn_ln_block_plain(
            x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2,
            ln2_scale, ln2_bias, act=act, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_ln_block: unsupported device {x.device}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_ffn_ln_block: unsupported dtype {dt}")
    H = x.shape[-1]
    I = w1.shape[-1]
    if H != KERNEL_HIDDEN or I % KERNEL_CHUNK:
        raise ValueError(
            f"fused_ffn_ln_block kernel takes H={KERNEL_HIDDEN} and I a "
            f"multiple of {KERNEL_CHUNK}, got H={H}, I={I}")
    if tuple(w1.shape) != (H, I) or tuple(w2.shape) != (I, H):
        raise ValueError(f"weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}"
                         f" do not match H={H}, I={I}")
    if attn_out.shape != x.shape or attn_out.dtype != dt:
        raise ValueError("attn_out must match x in shape and dtype")
    w1 = w1.to(dt)
    w2 = w2.to(dt)
    vecs = [t.float() for t in (ln1_scale, ln1_bias, b1, b2,
                                ln2_scale, ln2_bias)]
    for t in (x, attn_out, w1, w2, *vecs):
        if t.device != x.device:
            raise ValueError("fused_ffn_ln_block: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("fused_ffn_ln_block: tensors must be contiguous")
    for t, n in zip(vecs, (H, H, I, H, H, H)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"vector of shape {tuple(t.shape)}, expected ({n},)")
    M = x.numel() // H
    out = torch.empty_like(x)
    _build.check_aligned("fused_ffn_ln_block", x, attn_out, w1, w2, out)
    if M == 0:
        return out
    lib = _build.load("ffn_ln_block", _SIGNATURES)
    g1, be1, b1f, b2f, g2, be2 = vecs
    status = lib.ffn_ln_block(
        _DTYPES[dt], _build.ptr(x), _build.ptr(attn_out),
        _build.ptr(g1), _build.ptr(be1), _build.ptr(w1), _build.ptr(b1f),
        _build.ptr(w2), _build.ptr(b2f), _build.ptr(g2), _build.ptr(be2),
        _build.ptr(out), M, I, _ACTS[act], float(eps),
        _build.stream(x.device))
    _build.check(status, "ffn_ln_block")
    fused_ffn_ln_block.launches += 1
    return out


fused_ffn_ln_block.launches = 0
