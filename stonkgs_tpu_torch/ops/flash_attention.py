"""Inference attention: softmax(Q Kᵀ/√D + key_bias) V over (B, S, H, D).

Kernel: ``csrc/flash_attention_infer.cu`` (CUDA C++ for ``sm_90a``).  It
replaces the TPU kernel ``_infer_kernel`` of the JAX package
(``stonkgs_tpu/ops/flash_attention.py:359``, launched by ``_infer_call``
at ``:487``).

What bounds it on the H100: at the trunk's shape (B=128, S=512, H=12,
D=64, bf16) the two products are 4*B*H*S²*D = 103 GFLOP against 201 MB
of q, k, v and out, so operations bound it (0.104 ms at 989 TFLOP/s,
against 0.060 ms for the bytes at 3.35 TB/s).

Design: the TPU kernel runs one program per (batch, q-block) with all
heads unrolled inside, because TPU grid steps run in order and each has
a fixed cost.  On Hopper blocks run in parallel, so a block takes one
(b, h, 64-row q tile): 12,288 blocks at the trunk's shape for 132 SMs.
The block reads q, k and v straight from the (B, S, H, D) layout with
strides (no transposes, no padding of S: rows and keys past S are masked
inside the kernel).  Each of its four warps owns 16 query rows.  The TPU
kernel's rounding (probabilities normalised, then rounded to the input
dtype, ``flash_attention.py:375-385``) rules out the online softmax of
flash attention, which rounds before it normalises.  The first version
kept all fp32 score rows in shared memory (128 KB at S=512), which left
one block of four warps per SM and ran 8.4 ms at the trunk's shape on an
H100 SXM (700 W).  So
K streams through shared memory twice in 64-key tiles: pass 1 computes
each row's max and sum of exp, pass 2 recomputes the scores, normalises,
rounds and accumulates P V in fp32.  That costs half again the QKᵀ
products but needs ~54 KB, so four blocks share an SM.  bf16 products
run on the tensor cores (``nvcuda::wmma``); the fp32 instantiation uses
plain fp32 FMAs and exists to hold the whole model against the CPU.  The
kernel takes any S >= 1 and D = 64, the head width of every model in the
repo.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stonkgs_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 64
_P, _I, _F = _build.P, _build.I32, _build.F32
# int flash_attention_infer(dtype, q, k, v, key_bias, out, B, S, H, scale,
#                           stream)
_SIGNATURES = {"flash_attention_infer": [_I] + [_P] * 5 + [_I, _I, _I, _F, _P]}


def _key_bias(bias: Optional[torch.Tensor], B: int, S: int):
    """(B, 1, 1, S) additive key bias -> (B, S) fp32, or None."""
    if bias is None:
        return None
    if tuple(bias.shape) != (B, 1, 1, S):
        raise ValueError(f"bias must be (B, 1, 1, S) = {(B, 1, 1, S)}, "
                         f"got {tuple(bias.shape)}")
    return bias.reshape(B, S).float()


def flash_attention_infer_plain(q, k, v, bias=None):
    """Plain PyTorch version of the kernel: fp32 scores from products of
    the input dtype, fp32 softmax, probabilities normalised then rounded
    to the input dtype, P V accumulated in fp32."""
    B, S, H, D = q.shape
    f = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f)) * (1.0 / math.sqrt(D))
    kb = _key_bias(bias, B, S)
    if kb is not None:
        s = s + kb[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(f), v.to(f)).to(q.dtype)


def flash_attention_infer(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B, 1, 1, S) additive key bias
) -> torch.Tensor:
    """Deterministic attention, (B, S, H, D) in and out.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    if q.device.type == "cpu":
        return flash_attention_infer_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_infer: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_infer: unsupported dtype {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if D != KERNEL_HEAD_DIM or S < 1:
        raise ValueError(
            f"flash_attention_infer kernel takes D={KERNEL_HEAD_DIM} and "
            f"S >= 1, got D={D}, S={S}")
    kb = _key_bias(bias, B, S)
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError("q, k and v must share shape and dtype")
    for t in (q, k, v) + (() if kb is None else (kb,)):
        if t.device != q.device:
            raise ValueError("flash_attention_infer: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("flash_attention_infer: tensors must be contiguous")
    out = torch.empty_like(q)
    _build.check_aligned("flash_attention_infer", q, k, v, out)
    if B == 0 or H == 0:
        return out
    lib = _build.load("flash_attention_infer", _SIGNATURES)
    status = lib.flash_attention_infer(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(kb), _build.ptr(out), B, S, H, 1.0 / math.sqrt(D),
        _build.stream(q.device))
    _build.check(status, "flash_attention_infer")
    flash_attention_infer.launches += 1
    return out


flash_attention_infer.launches = 0
