"""Attention over (B, S, H, D): the inference kernel and the training pair.

Inference, softmax(Q Kᵀ/√D + key_bias) V
========================================

Kernel: ``csrc/flash_attention_infer.cu`` (CUDA C++ for ``sm_90a``).  It
replaces the TPU kernel ``_infer_kernel`` of the JAX package
(``stonkgs_tpu/ops/flash_attention.py:359``, launched by ``_infer_call``
at ``:487``).

What bounds it on the H100: at the trunk's shape (B=128, S=512, H=12,
D=64, bf16) the two products are 4*B*H*S²*D = 103 GFLOP against 402.7 MB
of q, k, v and out (4 x 128·512·768 x 2 bytes), so bytes bound it
(0.120 ms at 3.35 TB/s, against 0.104 ms for the products at
989 TFLOP/s).

Design: the TPU kernel runs one program per (batch, q-block) with all
heads unrolled inside, because TPU grid steps run in order and each has
a fixed cost.  On Hopper blocks run in parallel, so a block takes one
(b, h, 128-row q tile): 6,144 blocks at the trunk's shape for 132 SMs.
The TPU kernel's rounding (probabilities normalised, then rounded to the
input dtype, ``flash_attention.py:375-385``) rules out the online softmax
of flash attention, which rounds before it normalises.  So the kernel
makes two passes over the keys: pass 1 forms each row's max and sum of
exp, pass 2 recomputes the scores, normalises, rounds and accumulates
P V in fp32.  That sets the design's own floor above the bound: three
products (QKᵀ twice, PV once, 6·B·H·S²·D flops) and two exps a score.
At D=64 one exp a score costs the SFU (16 ex2 a clock an SM) about as
much time as one pass's products cost the tensor cores, so the kernel
is bound by the SFU and the tensor cores together (at ProtBERT's B=8,
S=3072, H=16: 1.21e9 scores, ~0.6 ms of exps and ~0.7 ms of products at
a realistic 650 TFLOP/s).

bf16 runs the Hopper kernel of ``csrc/attention_sm90.cuh`` (``sm_90a``):
384 threads a block.  A producer warpgroup (``setmaxnreg.dec``) streams
128-key tiles through a 3-stage ring of shared memory with TMA (one 4-D
tensor map per tensor over the (B, S, H, D) layout, 128-byte swizzle;
TMA zero-fills the ragged last tile) and writes each tile's key bias
beside it (-inf for keys >= S, which masks them), with full/empty
mbarriers; pass 1 streams K, pass 2 K and V.  Two consumer warpgroups
(``setmaxnreg.inc``) own 64 query rows each: S = QKᵀ is
``wgmma.m64n128k16`` from shared memory, O += PV is ``wgmma.m64n64k16``
with P from registers (the S accumulator packed to bf16 pairs is already
the A fragment) and V MN-major.  S and P never touch shared memory; the
softmax runs in registers, a row's max and sum across the 4 lanes that
hold it.  One consumer's exps overlap the other's products.

Numerics of the bf16 kernel against the plain version: products summed
in another order; each probability is exp2((s - m)·log2 e) on the SFU
times the row's reciprocal 1/l, not an IEEE exp and a division per
score.  Each moves the fp32 probability by a few ulps, so its bf16
rounding moves by at most one step at a rounding boundary, inside the
card's bf16 tolerance.  s, m and the logsumexp stay in the natural
domain, so a row whose keys all carry the -1e9 bias gets the plain
version's uniform probabilities.

fp32 runs the SIMT body ``attn_fwd_kernel`` of ``csrc/attention.cuh``
(64-row tiles, plain FMAs, an IEEE exp and division per score); it
exists to hold the whole model against the CPU.  Both take any S >= 1
and any head width D >= 1 (:func:`attention_kernel_takes`), as the JAX
package runs every D (its Pallas kernels where they fit, XLA beyond):
64 in BERT-base, BioBERT, ProtBERT and the BigBird trunk, 32 in
MiniLM-L12-H384 and in the 64-wide configs the CLI derives, 16 in the
32-wide ones, 4 and 2 in the 8- and 4-wide ones, 48, 80, 72 and 68 in
the configs it derives from 96-, 160-, 288- and 544-wide KG vectors (2,
2, 4 and 8 heads), 128, 256 and 384 in BERT-base's widths split into 6,
3 and 2 heads.  Below 8 the wrappers pad D to 8 (P = 16).  Past 256,
where a 64-row O accumulator of D fp32 columns alone would pass a
thread's registers and Q and K tiles of D columns a ring of shared
memory, bf16 runs the Hopper kernel of ``csrc/attention_wide_sm90.cuh``
(``attn_fwd_wide_sm90_kernel``): a block of 128 query rows (two consumer
warpgroups, whose first warp also feeds the ring: in 256 threads a thread
may take 255 registers, in more only 168, too few for a 64 x 128 score
tile beside an O part) forms the scores over the full D in column
blocks of 64, four ``wgmma.m64n128k16`` k-steps a block into one 64 x
128 fp32 tile, K's blocks (and Q's, past D = 512, where Q no longer
stays in shared memory beside the ring) streamed through a 3-stage TMA
ring; O is cut into column parts of 128, a grid axis, each part's block
running ``wgmma.m64n64k16`` with P from registers against its columns of
V.  Pass 1 is the same for every part, so a statistics launch writes
each row's (m, 1/l), and lse when training, to a (B, H, S) x 2 fp32
scratch, and the part blocks run pass 2 only:
parts + 2 score-sized products (2·B·H·S²·D flops each) and parts + 1
exps a score; at the trunk's B=128, S=512 and 2 heads of 384 (three
parts) 258 GFLOP, and about 2.0 GB read from L2 (K once per 128 rows per
launch, each part's V columns), against 0.24 TB for the kernels of a
warp a row that ran it before.  The bf16 backward past 256 runs the
kernels of ``csrc/attention_bwd_wide_sm90.cuh`` (see the training section
below).  fp32 past 128 still runs kernels of a warp a row
(``csrc/attention.cuh``'s ``attn_fwd_rows_kernel``; the backward's in
``csrc/flash_attention_train.cu``): each score a warp-wide sum over the
full D read 8 columns a lane from L2, the outputs cut into column parts
of 256 (8 columns a lane), a warp a part, each part forming every score
again and keeping its own softmax statistics over the true scores.
Up to 256 each kernel is instantiated at the padded widths P =
16, 32, 64, 128 and 256 and runs D on the smallest P >= D: the tensor
maps' dim 0 is D and their boxes P wide, so TMA
zero-fills the columns from D to P, which add nothing to QKᵀ, and the
columns of O past D are computed on zeros and not stored (the fp32
body zeroes and skips them in its loads and stores).  A row of P bf16
is one line of 2P bytes (32, 64 or 128) or, at P = 128, two column
blocks of 64 (a row of 256 bytes is wider than the widest swizzle,
128 bytes, of TMA and ``wgmma``); the boxes and the descriptors take
the swizzle of a line: QKᵀ runs P/16 k-steps, the steps past 64
columns in the second block, PV is ``wgmma.m64nPk16`` (two
``m64n64k16``, one a block, at P = 128), and the ring keeps its 3
stages (at P = 128 they fill the 227 KB a block may take).  At P = 256
a consumer's O accumulator alone is 128 registers a thread and a stage of
128 keys of K and V 128 KB, so that instance runs a block of 64 query
rows with one consumer warpgroup (256 threads, 255 registers a thread)
over 64-key tiles (three stages beside Q in 225 KB), and the backward
below takes 64-row tiles too.  TMA needs
every stride of a tensor map to be a multiple of 16 bytes, so a D that
is not a multiple of 8 (68 in bf16 is a 136-byte row) is copied into
zero-padded tensors of the next multiple of 8 and the outputs sliced
back; the scale stays 1/√D of the true D.  Padding costs products: D=48
runs at 64 (1.33x), D=80 at 128 (1.6x).  At D=128 the design's three
products outweigh its two exps a score, so the tensor cores bound it:
at B=128, S=512 and 6 heads, 155 GFLOP take 0.156 ms at 989 TFLOP/s,
against 0.097 ms for the exps and 0.120 ms for the bytes.

Training, with the TPU kernels' hash dropout
============================================

Kernels: ``csrc/flash_attention_train.cu``, two entry points.  They
replace ``_train_fwd_kernel`` (``stonkgs_tpu/ops/flash_attention.py:92``,
launched at ``:218``, with ``_dropout_keep`` at ``:69``) and
``_train_bwd_kernel`` (``:118``, launched at ``:267``).

What bounds them on the H100, counted as above (each input byte read once,
each output byte written once), at the pre-training step's shapes
(B=32, H=12, D=64, bf16):

* forward, trunk S=512 with key bias: 4*B*H*S²*D = 25.8 GFLOP against
  101.5 MB of q, k, v, out and the fp32 lse: bound by bytes, 0.030 ms at
  3.35 TB/s against 0.026 ms of products;
* forward, backbone S=256, no bias: 6.4 GFLOP against 50.7 MB, bound by
  bytes (0.015 ms);
* backward, trunk: 10*B*H*S²*D = 64.4 GFLOP against 202 MB (q, k, v, o,
  dO, lse and bias read; dq, dk, dv and db written): bound by operations,
  0.065 ms against 0.060 ms for the bytes (the design below recomputes S
  and dP̃ in both kernels: 14*B*H*S²*D of products, 0.091 ms at the
  peak).

Design.  The forward is the inference kernel (the Hopper kernel in bf16,
the SIMT body in fp32) with three additions: the fp32 logsumexp of each
row, the dropout of the normalised probabilities before they are
rounded (the hash of each score's position, ~12 integer operations a
score on top of the floor above), and the TPU kernel's padded keys
(S_pad - S keys of score -1e9, added to each row's max and sum
analytically; they change a row only when all its keys are masked).
The TPU backward runs one program per (b, h, q-block) and carries dK and
dV across the sequential q-blocks in fp32 scratch.  Hopper blocks run in
parallel, so the backward is three launches: a warp per row computes
delta = rowsum(dO·O); a block per (128-row query tile, head, batch)
streams the keys and forms dQ; a block per (128-key tile, head, batch)
streams the queries and forms dK and dV in fp32 registers, and adds its
keys' share of db into a zeroed (B, S) buffer with atomics.  The head
widths are the forward's (P/2 accumulator floats a thread in dQ, P in
dK/dV).  At P = 128 the ring is 2 stages deep, and a dK/dV block has one
consumer warpgroup of 64 keys in 256 threads, which takes its query
tiles in sub-steps of 32: with 128 accumulator floats a thread it
spilled under the 168 registers ptxas gives a thread of a 384-thread
block.  At P = 256 both kernels take 64-row tiles with one consumer
warpgroup in a 2-stage ring, dQ in sub-steps of 32 keys, and a dK/dV
block forms half of its keys' dK and dV columns (dK and dV of 64 keys at
256 columns would be 256 floats a thread): the two halves' blocks each
form the scores over all 256 columns.  The fp32 bodies above P = 128 are
not tiled (four 64 x 256 fp32 tiles are 266 KB): a warp owns a row and
column part and walks the other side's rows from L2.

Past D = 256 in bf16 (``csrc/attention_bwd_wide_sm90.cuh``) the backward
writes what the TPU kernel rounds anyway: a key-major dS pass (256
threads, two consumer warpgroups of 64 keys, warp 0 feeding a TMA ring
whose items hold one 64-column block of K, V, Q and dO) forms Sᵀ = K Qᵀ
and dP̃ᵀ = V dOᵀ once over the full D, takes p, the hash's keep bit and dS
in registers, adds db with one atomic a key and head, and stores
round(dS)ᵀ and round(p·mr)ᵀ into a bf16 scratch (keys by query rows);
hand-written ``wgmma`` GEMMs (128 x 128 output tiles in fp32 registers)
then form dK = scale·dSᵀ Q and dV = (p·mr)ᵀ dO, and dQ = scale·dS K with
the scratch read M-major.  Five products of 2·B·H·S²·D (at the 2-head
trunk, B=32, S=512, D=384: 64.4 GFLOP, 0.065 ms at 989 TFLOP/s) against
the seven of the instances up to 256 and the fifteen a flash-style pair
would make past them (S and dP̃ formed again for each column part of its
outputs).  The scratch takes 4·B·H·S² bytes; :func:`wide_backward_plan`
bounds it (``WIDE_BWD_SCRATCH_BYTES``, 1 GiB) with groups of heads, and
where one head passes the bound, chunks of query rows whose dK and dV the
GEMMs carry in fp32.  Up to 256, S and dP̃
are thus computed twice, for no cross-block reduction of dQ: the design's
floor is 7 products of 2·B·H·S²·D and two exps a score, plus the hash of
each score twice with dropout.  In bf16 the dQ and dK/dV kernels are
those of ``csrc/attention_bwd_sm90.cuh``, shaped as the forward: a
producer warpgroup streams the other operand pair's 128-row tiles
through a TMA ring (the forward's 4-D tensor maps) and writes each
tile's key bias, or its rows' lse and delta, beside it; two consumer
warpgroups of 64 rows run S = QKᵀ and dP̃ = dO Vᵀ (in dK/dV the
transposed Sᵀ = K Qᵀ and dP̃ᵀ = V dOᵀ) as ``wgmma.m64n128k16`` from shared
memory, the element pass in registers, and dQ += dS K (dV += (p·mr)ᵀ dO,
dK += dSᵀ Q) as ``wgmma.m64n64k16`` with the packed bf16 dS or p·mr from
registers as the A operand and K (dO, Q) MN-major.  S, dP̃, dS and p
never touch shared memory.  In fp32 they are the SIMT bodies of
``csrc/flash_attention_train.cu`` (64-row tiles, plain FMAs, an IEEE exp
per score).  Every launch regenerates the dropout mask from the hash of
the position.  The rounding points are the TPU kernels'
(``flash_attention.py:92-178``): products of the input dtype accumulated
in fp32, scale after the product, dS rounded to q's dtype before the dQ
and dK products, the dropped probabilities rounded to dO's dtype for dV.
The bf16 kernels take p = exp2((S·scale + bias − lse)·log2 e) on the
SFU, a few ulps from an IEEE exp: a rounded dS or p·mr moves by at most
one bf16 step at a rounding boundary.

The dropout hash indexes ((b·H + h)·S_pad + row)·S_pad + col, modulo 2³²,
where S_pad pads S to the TPU kernel's query block (``padded_length``):
on the card and in the plain version the mask is the JAX package's, bit
for bit, for the same two seed words.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from stonkgs_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths of the card's attention kernels (both dtypes): any D from
# 1 (the Hopper kernels' instances up to 256; past it bf16 on the wide
# wgmma kernels, fp32 a warp a row in column parts); the C entry points
# take multiples of 8, so the wrappers pad others with zero columns
ATTENTION_MIN_HEAD_DIM = 1
NEG_BIAS = -1e9  # score of a padded key, as the JAX package's NEG_BIAS
_P, _I, _U, _F = _build.P, _build.I32, _build.U32, _build.F32
# the dropout arguments of both training entry points:
# dropout, s_pad, threshold, seed0, seed1, keep_scale
_DROP = [_I, _I, _U, _U, _U, _F]
_SIGNATURES = {
    # int flash_attention_infer(dtype, q, k, v, key_bias, out, stats, B, S,
    #                           H, D, scale, stream)
    "flash_attention_infer": [_I] + [_P] * 6 + [_I, _I, _I, _I, _F, _P],
    # int flash_attention_infer_wide_calls(void)
    "flash_attention_infer_wide_calls": [],
}
_TRAIN_SIGNATURES = {
    # int flash_attention_train_fwd(dtype, q, k, v, key_bias, out, lse,
    #                               stats, B, S, H, D, scale, *dropout,
    #                               stream)
    "flash_attention_train_fwd": [_I] + [_P] * 7 + [_I, _I, _I, _I, _F] + _DROP + [_P],
    # int flash_attention_train_fwd_wide_calls(void)
    "flash_attention_train_fwd_wide_calls": [],
    # int flash_attention_train_bwd(dtype, q, k, v, key_bias, out, lse, dout,
    #                               dq, dk, dv, db, delta, ds, pd, dk_carry,
    #                               dv_carry, B, S, H, D, group, chunk, scale,
    #                               *dropout, stream)
    "flash_attention_train_bwd": [_I] + [_P] * 16 + [_I] * 6 + [_F] + _DROP + [_P],
    # int flash_attention_train_bwd_wide_calls(void)
    "flash_attention_train_bwd_wide_calls": [],
}


# the widest head width of the Hopper instances; the bf16 forward past it
# runs attn_fwd_wide_sm90_kernel in column parts
MAX_INSTANCE_HEAD_DIM = 256


def _wide_stats(q: torch.Tensor) -> Optional[torch.Tensor]:
    """The statistics scratch of the bf16 forward past
    ``MAX_INSTANCE_HEAD_DIM`` for the (padded) ``q``, or None."""
    B, S, H, D = q.shape
    if q.dtype != torch.bfloat16 or D <= MAX_INSTANCE_HEAD_DIM:
        return None
    return torch.empty((B, H, S, 2), dtype=torch.float32, device=q.device)


# the bytes the bf16 backward past MAX_INSTANCE_HEAD_DIM may take for its
# dS and dropped-P scratch (two bf16 matrices of keys x query rows a head)
WIDE_BWD_SCRATCH_BYTES = 1 << 30
# a chunk of query rows is a multiple of the GEMMs' 128-row tiles
WIDE_BWD_ROWS = 128
_MAX_GRID_Y = 65535


def _ld8(n: int) -> int:
    """n rounded up to a multiple of 8 (a scratch row of bf16 in 16-byte units)."""
    return -(-n // 8) * 8


def wide_backward_plan(B: int, S: int, H: int, D: int, dtype,
                       cap: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """(heads a group, query rows a chunk) of the bf16 backward past
    ``MAX_INSTANCE_HEAD_DIM`` at (padded) head width ``D``, or None (no
    scratch: D up to it, or fp32).  The kernels write round(dS) and the
    dropped P of a group of heads, keys by a chunk of query rows, into a
    bf16 scratch of ``4 · group · S · ⌈chunk⌉₈`` bytes: as many heads as
    fit in ``cap`` (at most the grid's 65,535), all S rows a chunk; where
    one head's scratch passes ``cap``, one head and the multiple of 128
    rows that fits (at least 128).  ``cap`` defaults to
    ``WIDE_BWD_SCRATCH_BYTES``, read at the call."""
    if dtype != torch.bfloat16 or D <= MAX_INSTANCE_HEAD_DIM:
        return None
    cap = WIDE_BWD_SCRATCH_BYTES if cap is None else cap
    head = 4 * S * _ld8(S)
    if head <= cap:
        return max(1, min(B * H, cap // head, _MAX_GRID_Y)), S
    rows = max(WIDE_BWD_ROWS, cap // (4 * S) // WIDE_BWD_ROWS * WIDE_BWD_ROWS)
    return 1, min(rows, S)


def wide_backward_pieces(B: int, S: int, H: int, plan: Tuple[int, int]):
    """The (first head, heads, first query row, rows) of each launch group
    of the backward past ``MAX_INSTANCE_HEAD_DIM`` under ``plan``, in the
    order the C entry point runs them (heads numbered b·H + h)."""
    group, chunk = plan
    return [(g0, min(group, B * H - g0), q0, min(chunk, S - q0))
            for g0 in range(0, B * H, group) for q0 in range(0, S, chunk)]


def _wide_bwd_scratch(q: torch.Tensor, plan):
    """The scratch of the bf16 backward past ``MAX_INSTANCE_HEAD_DIM`` for
    the (padded) ``q`` under ``plan``: (ds, pd), each (group, S, ⌈chunk⌉₈)
    bf16, and, where a chunk is shorter than S, the fp32 (B, S, H, D)
    carries of dK and dV (else None)."""
    if plan is None:
        return None, None, None, None
    B, S, H, D = q.shape
    group, chunk = plan
    ds, pd = (torch.empty((group, S, _ld8(chunk)), dtype=torch.bfloat16, device=q.device)
              for _ in range(2))
    if chunk >= S:
        return ds, pd, None, None
    dk_carry, dv_carry = (torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
                          for _ in range(2))
    return ds, pd, dk_carry, dv_carry


def wide_backward_calls() -> int:
    """How many calls of :func:`flash_attention_train_bwd` ran the bf16
    kernels past ``MAX_INSTANCE_HEAD_DIM`` (the dS pass and its GEMMs) in
    this process, as the kernels' library counts them (builds it on first
    use)."""
    return _build.load("flash_attention_train",
                       _TRAIN_SIGNATURES).flash_attention_train_bwd_wide_calls()


def wide_forward_calls() -> dict:
    """How many calls of each forward wrapper ran the bf16 kernel past
    ``MAX_INSTANCE_HEAD_DIM`` (``attn_fwd_wide_sm90_kernel``) in this
    process, as the kernels' own libraries count them: the route a check
    can read on the card (builds the libraries on first use)."""
    return {
        "flash_attention_infer": _build.load(
            "flash_attention_infer", _SIGNATURES).flash_attention_infer_wide_calls(),
        "flash_attention_train_fwd": _build.load(
            "flash_attention_train", _TRAIN_SIGNATURES).flash_attention_train_fwd_wide_calls()}


def _key_bias(bias: Optional[torch.Tensor], B: int, S: int):
    """(B, 1, 1, S) additive key bias -> (B, S) fp32, or None."""
    if bias is None:
        return None
    if tuple(bias.shape) != (B, 1, 1, S):
        raise ValueError(f"bias must be (B, 1, 1, S) = {(B, 1, 1, S)}, "
                         f"got {tuple(bias.shape)}")
    return bias.reshape(B, S).float()


def attention_kernel_takes(D: int) -> bool:
    """Whether the card's attention kernels (inference, the training
    forward and backward, in fp32 and bf16) take head width ``D``: any D
    from 1 up."""
    return D >= ATTENTION_MIN_HEAD_DIM


def check_attention_shape(what: str, S: int, D: int) -> None:
    """Raise unless the attention kernels take a sequence of ``S`` rows
    (S >= 1) at head width ``D`` (:func:`attention_kernel_takes`)."""
    if not attention_kernel_takes(D) or S < 1:
        raise ValueError(f"{what} kernel takes any D from {ATTENTION_MIN_HEAD_DIM} up "
                         f"and S >= 1, got D={D}, S={S}")


def _pad_heads(*tensors):
    """(B, S, H, D) tensors zero-padded to a head width that is a multiple
    of 8 (the kernels' strides are multiples of 16 bytes), or as they are
    if D is one already (None stays None)."""
    D = tensors[0].shape[-1]
    if D % 8 == 0:
        return tensors
    pad = -D % 8
    return tuple(None if t is None else torch.nn.functional.pad(t, (0, pad))
                 for t in tensors)


def _unpad(D: int, *tensors):
    """The first ``D`` columns of each padded output, contiguous."""
    return tuple(t if t.shape[-1] == D else t[..., :D].contiguous() for t in tensors)


def _check_cuda_inputs(what: str, q: torch.Tensor, others, extra=()) -> None:
    """Raise unless q and ``others`` (same shape and dtype as q) and
    ``extra`` are contiguous tensors on q's CUDA device that the kernels
    take: (B, S, H, D) in fp32 or bf16, S >= 1, D >= 1."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    _, S, _, D = q.shape
    check_attention_shape(what, S, D)
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{what}: q, k, v (and o, dO) must share shape and dtype")
    for t in (q, *others, *(t for t in extra if t is not None)):
        if t.device != q.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

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
    B, S, H, D = q.shape
    kb = _key_bias(bias, B, S)
    _check_cuda_inputs("flash_attention_infer", q, (k, v), (kb,))
    if B == 0 or H == 0:
        return torch.empty_like(q)
    q, k, v = _pad_heads(q, k, v)
    out, stats = torch.empty_like(q), _wide_stats(q)
    _build.check_aligned("flash_attention_infer", q, k, v, out)
    lib = _build.load("flash_attention_infer", _SIGNATURES)
    status = lib.flash_attention_infer(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(kb), _build.ptr(out), _build.ptr(stats), B, S, H, q.shape[-1],
        1.0 / math.sqrt(D), _build.stream(q.device))
    _build.check(status, "flash_attention_infer")
    flash_attention_infer.launches += 1
    return _unpad(D, out)[0]


flash_attention_infer.launches = 0


# ---------------------------------------------------------------------------
# training: the dropout hash
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def padded_length(S: int, block_q: int = 256) -> int:
    """S padded to the TPU training kernels' query block: ``ceil(S/bq)·bq``
    with ``bq = min(block_q, S)``, and block_q at most 128 when S > 1024
    (``stonkgs_tpu/ops/flash_attention.py:181-183, 540-541``).  The
    dropout hash indexes positions of the padded (S_pad, S_pad) grid."""
    if S > 1024:
        block_q = min(block_q, 128)
    bq = min(block_q, S)
    return -(-S // bq) * bq


def dropout_threshold(rate: float) -> int:
    """uint32 threshold: a position is kept iff its hash < threshold."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _seed_words(seed) -> Tuple[int, int]:
    """Two int32 seed words (a (2,) CPU tensor or two ints) as uint32."""
    words = seed.tolist() if isinstance(seed, torch.Tensor) else list(seed)
    if len(words) != 2:
        raise ValueError(f"the dropout seed is two 32-bit words, got {words}")
    return int(words[0]) & _MASK32, int(words[1]) & _MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): c is split into 16-bit
    halves so that no product leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def dropout_keep_plain(seed, B: int, H: int, s_pad: int, rows: torch.Tensor,
                       cols: torch.Tensor, rate: float) -> torch.Tensor:
    """The JAX package's ``_dropout_keep`` (``flash_attention.py:69-89``)
    as a (B, H, len(rows), len(cols)) bool mask: a murmur3-finalizer hash
    of ((b·H + h)·s_pad + row)·s_pad + col and the two seed words, every
    step modulo 2**32, kept iff hash < ``dropout_threshold(rate)``."""
    s0, s1 = _seed_words(seed)
    dev = rows.device
    bh = torch.arange(B * H, dtype=torch.int64, device=dev).view(B, H, 1, 1)
    r = rows.to(torch.int64).view(1, 1, -1, 1)
    c = cols.to(torch.int64).view(1, 1, 1, -1)
    x = (_mul32((_mul32(bh, s_pad) + r) & _MASK32, s_pad) + c) & _MASK32
    x = x ^ s0
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 16) ^ s1
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 13)
    x = _mul32(x, 0x27D4EB2F)
    x = x ^ (x >> 16)
    return x < dropout_threshold(rate)


def _dropout_args(rate: float, seed, S: int, block_q: int) -> list:
    """The kernels' dropout arguments (dropout, s_pad, threshold, seed0,
    seed1, keep_scale)."""
    s0, s1 = _seed_words(seed)
    return [int(rate > 0.0), padded_length(S, block_q), dropout_threshold(rate),
            s0, s1, 1.0 / (1.0 - rate)]


# ---------------------------------------------------------------------------
# training: plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def flash_attention_train_fwd_plain(q, k, v, bias=None, seed=(0, 0), rate=0.0,
                                    block_q=256):
    """Plain PyTorch version of the training forward kernel.

    Returns (out (B, S, H, D) in q's dtype, lse (B, H, S) fp32): fp32
    scores s = (q·kᵀ)·scale + bias from products of the input dtype, the
    TPU kernel's S_pad - S padded keys at score -1e9, lse = m + log Σ
    exp(s - m), probabilities normalised, dropped with scale 1/(1-rate),
    rounded to v's dtype, P V accumulated in fp32."""
    B, S, H, D = q.shape
    f = torch.float32
    s_pad = padded_length(S, block_q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f)) * (1.0 / math.sqrt(D))
    kb = _key_bias(bias, B, S)
    if kb is not None:
        s = s + kb[:, None, None, :]
    if s_pad > S:
        s = torch.cat([s, s.new_full((B, H, S, s_pad - S), NEG_BIAS)], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom))[..., 0]
    pn = (p / denom)[..., :S]
    if rate > 0.0:
        idx = torch.arange(S, device=q.device)
        keep = dropout_keep_plain(seed, B, H, s_pad, idx, idx, rate)
        pn = torch.where(keep, pn * (1.0 / (1.0 - rate)), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", pn.to(v.dtype).to(f), v.to(f))
    return out.to(q.dtype).contiguous(), lse.contiguous()


def flash_attention_train_bwd_plain(q, k, v, bias, out, lse, dout, seed=(0, 0),
                                    rate=0.0, block_q=256, need_db=True):
    """Plain PyTorch version of the training backward kernel.

    Returns (dq, dk, dv, db): p = exp(s - lse) recomputed; dp = (dO·Vᵀ)·mr,
    mr = 1/(1-rate) where the hash keeps and 0 where it drops; delta =
    Σ dO·O in fp32; dS = p·(dp - delta) in fp32, rounded to q's dtype for
    the dQ and dK products; the dropped p rounded to dO's dtype for dV;
    db (B, S) = Σ over rows and heads of the fp32 dS (None unless
    ``need_db``)."""
    B, S, H, D = q.shape
    f = torch.float32
    scale = 1.0 / math.sqrt(D)
    dout = dout.to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f)) * scale
    kb = _key_bias(bias, B, S)
    if kb is not None:
        s = s + kb[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(f), v.to(f))
    pd = p
    if rate > 0.0:
        idx = torch.arange(S, device=q.device)
        keep = dropout_keep_plain(seed, B, H, padded_length(S, block_q), idx, idx, rate)
        mr = torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(f)
        pd = p * mr
        dp = dp * mr
    delta = (dout.to(f) * out.to(f)).sum(dim=-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    ds_lp = ds.to(q.dtype).to(f)
    dq = (scale * torch.einsum("bhqk,bkhd->bqhd", ds_lp, k.to(f))).to(q.dtype)
    dk = (scale * torch.einsum("bhqk,bqhd->bkhd", ds_lp, q.to(f))).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(dout.dtype).to(f), dout.to(f)).to(v.dtype)
    db = ds.sum(dim=(1, 2)) if need_db else None
    return dq.contiguous(), dk.contiguous(), dv.contiguous(), db


def flash_attention_train_fwd(q, k, v, bias=None, seed=(0, 0), rate=0.0, block_q=256):
    """Training forward: (out, lse), as :func:`flash_attention_train_fwd_plain`.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if q.device.type == "cpu":
        return flash_attention_train_fwd_plain(q, k, v, bias, seed, rate, block_q)
    B, S, H, D = q.shape
    kb = _key_bias(bias, B, S)
    _check_cuda_inputs("flash_attention_train_fwd", q, (k, v), (kb,))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B == 0 or H == 0:
        return torch.empty_like(q), lse
    q, k, v = _pad_heads(q, k, v)
    out, stats = torch.empty_like(q), _wide_stats(q)
    _build.check_aligned("flash_attention_train_fwd", q, k, v, out)
    lib = _build.load("flash_attention_train", _TRAIN_SIGNATURES)
    status = lib.flash_attention_train_fwd(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(kb), _build.ptr(out), _build.ptr(lse), _build.ptr(stats), B, S, H,
        q.shape[-1], 1.0 / math.sqrt(D), *_dropout_args(rate, seed, S, block_q),
        _build.stream(q.device))
    _build.check(status, "flash_attention_train_fwd")
    flash_attention_train_fwd.launches += 1
    return _unpad(D, out)[0], lse


flash_attention_train_fwd.launches = 0


def flash_attention_train_bwd(q, k, v, bias, out, lse, dout, seed=(0, 0), rate=0.0,
                              block_q=256, need_db=True):
    """Training backward: (dq, dk, dv, db), as
    :func:`flash_attention_train_bwd_plain`; ``dout`` in q's dtype.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if q.device.type == "cpu":
        return flash_attention_train_bwd_plain(q, k, v, bias, out, lse, dout, seed,
                                               rate, block_q, need_db)
    B, S, H, D = q.shape
    kb = _key_bias(bias, B, S)
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 (B, H, S), got {lse.dtype} {tuple(lse.shape)}")
    _check_cuda_inputs("flash_attention_train_bwd", q, (k, v, out, dout), (kb, lse))
    db = torch.zeros((B, S), dtype=torch.float32, device=q.device) if need_db else None
    if B == 0 or H == 0:
        return (*(torch.empty_like(q) for _ in range(3)), db)
    q, k, v, out, dout = _pad_heads(q, k, v, out, dout)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    plan = wide_backward_plan(B, S, H, q.shape[-1], q.dtype)
    scratch = _wide_bwd_scratch(q, plan)
    _build.check_aligned("flash_attention_train_bwd", q, k, v, out, dout, dq, dk, dv, *scratch)
    lib = _build.load("flash_attention_train", _TRAIN_SIGNATURES)
    status = lib.flash_attention_train_bwd(
        _DTYPES[q.dtype], *(_build.ptr(t) for t in (q, k, v, kb, out, lse, dout, dq, dk,
                                                    dv, db, delta, *scratch)),
        B, S, H, q.shape[-1], *(plan or (0, 0)), 1.0 / math.sqrt(D),
        *_dropout_args(rate, seed, S, block_q), _build.stream(q.device))
    _build.check(status, "flash_attention_train_bwd")
    flash_attention_train_bwd.launches += 1
    return (*_unpad(D, dq, dk, dv), db)


flash_attention_train_bwd.launches = 0


class _FlashAttentionTrain(torch.autograd.Function):
    """The training pair as one autograd function; it saves what the JAX
    custom VJP saves: q, k, v, the bias, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, block_q):
        out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate, block_q)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.dropout = (seed, rate, block_q)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        seed, rate, block_q = ctx.dropout
        need_db = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, db = flash_attention_train_bwd(
            q, k, v, bias, out, lse, g.to(q.dtype).contiguous(), seed, rate, block_q,
            need_db)
        dbias = db.reshape(bias.shape).to(bias.dtype) if need_db else None
        return dq, dk, dv, dbias, None, None, None


def flash_attention_train(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B, 1, 1, S) additive key bias
    *,
    dropout_rate: float = 0.0,
    seed: Optional[Sequence[int]] = None,  # two int32 words, e.g. a (2,) CPU tensor
    block_q: int = 256,
) -> torch.Tensor:
    """Differentiable attention with the TPU kernels' hash dropout.

    Dropout applies when ``dropout_rate > 0`` and ``seed`` is given, as
    in the JAX package's ``flash_attention_train`` (whose two key words,
    bitcast to int32, are the seed).  ``block_q`` only sets S_pad, and so
    the hash (see :func:`padded_length`).  The backward recomputes the
    probabilities from the saved logsumexp; the bias gets a gradient when
    it requires one."""
    if dropout_rate > 0.0 and seed is not None:
        rate, words = float(dropout_rate), _seed_words(seed)
    else:
        rate, words = 0.0, (0, 0)
    return _FlashAttentionTrain.apply(q, k, v, bias, words, rate, block_q)
