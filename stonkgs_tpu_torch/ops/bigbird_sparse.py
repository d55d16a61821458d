"""BigBird block-sparse attention (HF ``BigBirdBlockSparseAttention``).

The port of the JAX package's ``stonkgs_tpu/ops/bigbird_sparse.py`` (the
random-block plan and the semantics) and ``ops/bigbird_sparse_pallas.py``
(the kernels), in one module.  Per query block: the 2 global blocks
(first and last), a 3-block sliding window and ``r`` random key blocks;
the first and last query blocks attend the whole sequence; masked keys
take the penalty -10000 (not BERT's -1e9); the context is multiplied by
the query mask.

The random plan
===============

HF reseeds ``np.random.seed(layer)`` on every forward, so the plan is a
host-side constant per (layer, mode), and all zeros in eval mode.
:func:`build_rand_attn` replays HF's call sequence with a local
``np.random.RandomState(layer)``: the same stream as the global seed,
without touching the global state.

Kernels: the middle query blocks
================================

``csrc/bigbird_sparse.cu`` (CUDA C++ for ``sm_90a``), two entry points.
They replace ``_mid_blocks_kernel`` (``stonkgs_tpu/ops/
bigbird_sparse_pallas.py:83``, launched at ``:227``, with ``_gather_kv``
at ``:51`` and ``_mid_logits`` at ``:70``) and ``_mid_blocks_bwd_kernel``
(``:113``, launched at ``:272``).

The kernels take any head width D >= 1 and any block size bs >= 1 with S
a multiple of it of at least 5 blocks (:func:`bigbird_kernel_takes`), as
the JAX package runs every geometry (its Pallas kernel at blocks that are
multiples of 8, ``bigbird_sparse_pallas.py:54-55``, XLA's block-sparse
attention elsewhere); the command line's ``block_size = max(S // 8, 4)``
gives 25 at S = 200, 4 at S = 32 and 2,048 at S = 16,384.  There is no
fallback to the plain versions on the card.  bf16 up to D = 64 runs the
Hopper kernels at the padded widths 16, 32 and 64, which take the true D
at run time (the tensor maps' dimension, the stores' columns) and the
block size at run time too (a block is ⌈bs/64⌉ row tiles, the last one
partial and masked; below 64 one tile holds rows of the next blocks,
computed and not stored).  The C entry points take a D that is a
multiple of 8, so the wrappers pad any other D (36: a 72-byte bf16 row,
which TMA's 16-byte strides refuse; 4: the 8-wide configs' heads) with
zero columns and slice the outputs back.  The logit scale is 1/√D of the
true D, rounded to bf16 as JAX rounds it: D = 16, 32 and 64 keep their
exact instances with the scale fixed at compile time, every other D runs
a padded instance that takes the scale at run time and rounds the scaled
logit again.  Past D = 64 (6 heads of 128 at the trunk's 768) the Hopper
kernels' shared memory has no room (a forward stage holds 64 x D K and V
tiles of two query blocks, the backward fp32 64 x D dK and dV staging a
consumer).  There the bf16 forward runs ``csrc/bigbird_wide_sm90.cuh``
(``bigbird_fwd_wide_sm90_kernel``, the design of the dense attention's
forward past D = 256): 256 threads, two consumer warpgroups of 64 query
rows whose first warp feeds a TMA ring of 64 x 64 tiles, the scores over
the full D in column blocks of 64 (four ``wgmma.m64n64k16`` k-steps each),
O in column parts of 128 with P from registers; up to D = 128 one launch
runs both passes, past it a statistics launch writes each row's (m, 1/l)
into a (B, H, (nb-2)·bs) x 2 fp32 scratch (:func:`_wide_stats`) and lse,
and a block per part runs pass 2.  At the 6-head trunk (B=8, bs 64, r 3)
that is three products of 2·B·H·(nb-2)·bs·512·D, 0.076 ms at 989
TFLOP/s, over 0.059 ms of bytes.  The bf16 backward past D = 64 runs
``csrc/bigbird_bwd_wide_sm90.cuh`` (``bigbird_bwd_wide_sm90_kernel``):
a CTA is one warpgroup of 128 threads that owns a 64-row query tile and
an output part of 128 columns (a grid axis past D = 128), its first warp
feeding a 4-stage TMA ring; per 64-key slot sub-tile S and dP run over
the full D in column blocks of 64 (each block's dP in its own
accumulator, added in fp32), Q and dO of the part's columns stay in
shared memory and the other blocks stream beside K and V; dQ of the
part's columns stays in registers (dS hi and lo as the A fragments), dK
= dSᵀQ and dV = round(p)ᵀdO run a column block at a time and go to the
fp32 accumulators through TMA reduce-adds.  At the 6-head training plan
(B=2, bs 64, r 3) that is seven products of 2·B·H·(nb-2)·bs·512·D, 0.044
ms at 989 TFLOP/s.  fp32 at every D past 64 runs the SIMT bodies of
``csrc/bigbird_sparse.cu`` in column parts of 64: a CTA a (64-row tile,
part) forms the full-D scores over 64-column chunks of Q and K (dP over
chunks of dO and V), keeps its own softmax statistics, and makes its
products over its part's columns: D/64 times the scores' products of
one pass, there to hold the model against the CPU.

What bounds them on the H100, at the trunk's shape (S=4096, H=12, D=64,
r=3, so W = (5+r)·bs keys per middle query block), counting each input
byte once and each output byte once, products at 989 TFLOP/s and bytes
at 3.35 TB/s:

* bs=64 (W=512, 62 middle blocks): the forward at B=8 does 4·B·H·(nb-2)
  ·bs·W·D = 49.9 GFLOP against q's middle rows, k, v and out (~4 × 50.3
  MB) plus the mask and the fp32 lse: 0.050 ms of products against 0.061
  ms of bytes, bound by bytes; the backward at B=2 does 10·B·H·(nb-2)·bs
  ·W·D (the logits recomputed, dP, dQ, dK, dV) = 31.2 GFLOP against q, k,
  v, o, dO read and dq, dk, dv written (~8 × 12.6 MB) plus lse: 0.032 ms
  of products, 0.030 ms of bytes, bound by operations;
* bs=128 (W=1,024, 30 middle blocks): twice the keys a query row, so
  96.6 GFLOP at B=8 (0.098 ms) against about the same bytes (0.059 ms)
  and 60.4 GFLOP for the backward at B=2 (0.061 ms): both bound by
  operations.  On the TPU, 128-wide blocks filled the 128 × 128 matrix
  unit; the H100's ``wgmma`` is full at 64 rows, so block 128 is a model
  the card must run, not a faster mode.

The same counts give any (bs, D, r, H, S): the products grow with bs·D,
the bytes with D, and the exps (two a score in the forward, one in the
backward) with bs alone, so at D = 32 or 16 the SFU's floor weighs two
or four times as much against the products as at D = 64.  A block size
that is not a multiple of 64 pads its last query tile and its last key
sub-tile to 64 rows: the kernels do (64·⌈bs/64⌉ / bs)² of the useful
products (64 times at bs = 8, 1.78 at bs = 96).

The design's floor on top of that bound (``csrc/bigbird_sm90.cuh``): the
forward's two passes need 2 exps a score, 0.093 ms of the SFU at B=8,
bs=64 (16 ex2 a clock an SM) and 0.180 ms at bs=128, above its 3 products
(0.076 and 0.146 ms); the backward's 7 products (dS as two bf16 terms)
take 0.044 ms at B=2, bs=64 and 0.086 ms at bs=128.

Design.  The TPU kernel keeps a whole (S, D) key and value slice in VMEM
per (batch, head) and assembles the key blocks of a middle query block by
VMEM-to-VMEM slices.  On Hopper (bf16, ``csrc/bigbird_sm90.cuh``) a CTA
of 384 threads has two consumer warpgroups of 64 query rows each (the
``wgmma`` M) and a producer warp that streams 64-key sub-tiles of the
slots [g0 | window i-1, i, i+1 | g_last | random r] through a TMA ring,
from 4-D tensor maps built over the (B, S, H, D) views with their strides
(:func:`tma_map_args` states which strides a map takes), with each
sub-tile's penalties beside it.  A row of D bf16 is a line of 2D bytes,
and TMA and the ``wgmma`` descriptors take the swizzle of that width
(128, 64 or 32 bytes), as the dense attention kernels do.  A block is
T = ⌈bs/64⌉ row tiles.  At T = 1 (bs ≤ 64) the two consumers take two
neighbouring middle query blocks of one (batch, head), and a ring stage
holds a slot sub-tile of each; at T ≥ 2 they take two neighbouring 64-row
tiles of one query block (⌈T/2⌉ CTAs a block), a slot is T ring steps of
one 64-key sub-tile that both read, and the ring has twice as many
one-tile stages (the same shared memory): the row statistics span all
(5+r)·T sub-tiles, and the penalty of key c of sub-tile u of slot block
blk is that of mask[b, bs·blk + 64·u + c].  Where bs is not a multiple
of 64 the last tiles are partial: keys past the block take the penalty
-inf (weight exactly 0; a key the mask pads keeps -10000 and its weight),
query rows past the block are computed but not stored, and in the
backward their p and dS are 0, so they add nothing into other blocks'
dK and dV.  Widening a step to a 128-key tile instead would push the
backward's dS and P tiles past the 227 KB a CTA may take.  The forward
makes two passes over the sub-tiles (row max and sum of exp, then
normalised probabilities, rounded, times V), because the TPU kernel
normalises before it rounds, as the port's dense attention kernels do;
Q·Kᵀ and P·V run on ``wgmma``, the softmax in registers.  The (B, S) mask
is read in the kernel, and the duplicate window slot at query blocks 1
and nb-2 (where the window holds a global block) takes the penalty there
(all its sub-tiles): the TPU kernel's gathered mask outside the kernel
was a Mosaic workaround.  The eval plan is all zeros: its random slots
repeat block 0, each as a key of its own in the softmax, as the TPU
kernel and HF count them.

The TPU backward carries dK and dV in VMEM across the sequential j axis.
Hopper blocks run in no order, so each consumer forms a sub-tile's 64 × D
dK and dV on ``wgmma`` and adds them into fp32 (B, S, H, D) accumulators
with TMA reduce-adds (the adds land in an order that changes from run to
run; at T ≥ 2 every tile of a query block adds into the same key rows);
the global blocks take one add from each middle query tile of their
(batch, head).  The wrapper casts the accumulators to the input dtype.
dQ of a middle block's rows is the consumer's own and is written once.
The fp32 instantiations (``csrc/bigbird_sparse.cu``) are SIMT bodies
with plain fp32 FMAs and ``atomicAdd``, one CTA a 64-row tile, there to
hold the model against the CPU; no bf16 call runs them.

Rounding, as ``_mid_logits`` and the two TPU kernels: Q·Kᵀ accumulated in
fp32 from products of the input dtype, rounded to it, times 1/√D in the
input dtype (JAX multiplies a bf16 array by a Python float in bf16, so
the scale itself is rounded: 0.1767578125 at D=32, 0.2041015625 at
D=24, with D the true head width, never the padded one), rounded again
(exact at D=16 and 64, where the scale is a power of two; the bf16
kernels make the second rounding at every other D), plus the fp32
penalty; softmax in
fp32; probabilities normalised, then rounded; P·V in fp32, the output
rounded; the lse in fp32.  Backward: p = exp(logits - lse); dP = dO·Vᵀ;
row = Σ dO⊙O; dS = p(dP - row)/√D in fp32; dq = dS·K rounded; dK =
dSᵀ·q; dV = round(p)ᵀ·dO, all in fp32.  The bf16 kernel feeds dS to the
tensor cores as the sum of two bf16 terms (hi = round(dS), lo = round(dS
- hi)), which carries 16 of its 24 significant bits, takes its exps from
the SFU's ``ex2.approx`` and divides by l as a per-row reciprocal; the
fp32 instantiation multiplies in plain fp32.

The first and last query blocks are dense rows in plain PyTorch under
autograd, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from stonkgs_tpu_torch.ops import _build
from stonkgs_tpu_torch.ops.flash_attention import _pad_heads, _unpad

ATTN_PENALTY = -10000.0
KERNEL_TILE = 64            # rows of the kernels' tiles (a block is ⌈bs/64⌉ of them)
KERNEL_MIN_BLOCKS = 5       # blocks of a sequence: at least 5 (global, window, global)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = _build.P, _build.I32, _build.I64, _build.F32
_SIGNATURES = {
    # int bigbird_mid_fwd(dtype, q, k, v, mask, rand, out, lse, stats, B, S,
    #                     H, r, bs, D, sb, ss, sh, scale, stream)
    "bigbird_mid_fwd": [_I] + [_P] * 8 + [_I] * 6 + [_L] * 3 + [_F, _P],
    # int bigbird_mid_fwd_wide_calls(void)
    "bigbird_mid_fwd_wide_calls": [],
    # int bigbird_mid_bwd_wide_calls(void)
    "bigbird_mid_bwd_wide_calls": [],
    # int bigbird_mid_bwd(dtype, q, k, v, mask, rand, out, lse, dout, dq, dk,
    #                     dv, B, S, H, r, bs, D, sb, ss, sh, scale, stream)
    "bigbird_mid_bwd": [_I] + [_P] * 11 + [_I] * 6 + [_L] * 3 + [_F, _P],
}


# ---------------------------------------------------------------------------
# the random-block plan (HF's np.random stream, replayed)
# ---------------------------------------------------------------------------

def _rand_mask_fixed_plan(max_seqlen: int, block_size: int, n_rand: int, last_idx: int,
                          rs: np.random.RandomState) -> np.ndarray:
    """HF ``_bigbird_block_rand_mask`` (training path), one head."""
    nb = max_seqlen // block_size
    out = np.zeros((nb - 2, n_rand), np.int32)
    middle = np.arange(1, nb - 1, dtype=np.int32)
    last = nb - 1
    if last_idx > (2 * block_size):
        last = (last_idx // block_size) - 1
    for i in range(1, nb - 1):
        start, end = i - 2, i
        if i == 1:
            out[i - 1] = rs.permutation(middle[2:last])[:n_rand]
        elif i == 2:
            out[i - 1] = rs.permutation(middle[3:last])[:n_rand]
        elif i in (nb - 3, nb - 2):
            out[i - 1] = rs.permutation(middle[:last])[:n_rand]
        elif start > last:
            out[i - 1] = rs.permutation(middle[:last])[:n_rand]
        elif (end + 1) == last:
            out[i - 1] = rs.permutation(middle[:start])[:n_rand]
        else:
            out[i - 1] = rs.permutation(
                np.concatenate((middle[:start], middle[end + 1: last])))[:n_rand]
    return out


def _single_row_rand(block_id: int, to_start: int, to_end: int, n_rand: int,
                     rs: np.random.RandomState) -> np.ndarray:
    """HF ``_get_single_block_row_attention`` with window and global 1."""
    perm = rs.permutation(np.arange(to_start, to_end, dtype=np.int32))
    illegal = set(range(block_id - 1, block_id + 2))
    illegal.add(0)
    illegal.add(to_end - 1)
    if block_id == 1:
        illegal.add(to_end - 2)
    if block_id == to_end - 2:
        illegal.add(1)
    picked = []
    for v in perm:
        if int(v) not in illegal:
            picked.append(int(v))
        if len(picked) == n_rand:
            break
    return np.asarray(picked, np.int32)


def _rand_mask_with_plan(seq_len: int, block_size: int, n_rand: int, num_heads: int,
                         rs: np.random.RandomState) -> list:
    """HF ``_bigbird_block_rand_mask_with_head`` for the single- or
    two-phase plan of ``_get_rand_attn_plan``."""
    nb = seq_len // block_size
    if (2 * n_rand + 5) < nb:
        plan_len = [(2 * n_rand + 5) * block_size, seq_len]
        plan_cnt = [n_rand, 0]
    elif (n_rand + 5) < nb:
        plan_len = [(n_rand + 5) * block_size, seq_len]
        plan_cnt = [n_rand // 2, n_rand - n_rand // 2]
    else:
        plan_len = [seq_len]
        plan_cnt = [n_rand]
    plan_blocks = np.array(plan_len) // block_size
    max_plan_idx = plan_len.index(seq_len)

    rand_attn = [np.zeros((nb, int(np.sum(plan_cnt[: max_plan_idx + 1]))), np.int32)
                 for _ in range(num_heads)]
    for plan_idx in range(max_plan_idx + 1):
        rnd_r_cnt = 0
        if plan_idx > 0:
            if plan_cnt[plan_idx] > 0:
                rnd_r_cnt = int(np.sum(plan_cnt[:plan_idx]))
                curr = int(np.sum(plan_cnt[: plan_idx + 1]))
                for row in range(1, plan_blocks[plan_idx - 1]):
                    for h in range(num_heads):
                        rand_attn[h][row, rnd_r_cnt:curr] = _single_row_rand(
                            row, plan_blocks[plan_idx - 1], plan_blocks[plan_idx],
                            plan_cnt[plan_idx], rs)
            for pl_id in range(plan_idx):
                if plan_cnt[pl_id] == 0:
                    continue
                for row in range(plan_blocks[plan_idx - 1], plan_blocks[plan_idx]):
                    r0, start = 0, 0
                    if pl_id > 0:
                        r0 = int(np.sum(plan_cnt[:pl_id]))
                        start = plan_blocks[pl_id - 1]
                    curr = int(np.sum(plan_cnt[: pl_id + 1]))
                    for h in range(num_heads):
                        rand_attn[h][row, r0:curr] = _single_row_rand(
                            row, start, plan_blocks[pl_id], plan_cnt[pl_id], rs)
        if plan_cnt[plan_idx] == 0:
            continue
        curr = int(np.sum(plan_cnt[: plan_idx + 1]))
        from_start, to_start = 1, 0
        if plan_idx > 0:
            rnd_r_cnt = int(np.sum(plan_cnt[:plan_idx]))
            from_start = plan_blocks[plan_idx - 1]
            to_start = plan_blocks[plan_idx - 1]
        for row in range(from_start, plan_blocks[plan_idx]):
            for h in range(num_heads):
                rand_attn[h][row, rnd_r_cnt:curr] = _single_row_rand(
                    row, to_start, plan_blocks[plan_idx], plan_cnt[plan_idx], rs)
    return [ra[1: nb - 1, :] for ra in rand_attn]


def build_rand_attn(seq_len: int, block_size: int, num_random_blocks: int,
                    num_heads: int, num_layers: int, max_seqlen: int,
                    training: bool) -> np.ndarray:
    """(L, H, nb-2, r) int32 random-block plan: layer ``i`` draws from
    ``RandomState(i)`` (HF seeds ``np.random.seed(i)``); all zeros in eval
    mode."""
    nb = seq_len // block_size
    r = num_random_blocks
    out = np.zeros((num_layers, num_heads, nb - 2, r), np.int32)
    if not training:
        return out
    for layer in range(num_layers):
        rs = np.random.RandomState(layer)
        if seq_len in (1024, 3072, 4096):
            per_head = [_rand_mask_fixed_plan(max_seqlen, block_size, r, 1024, rs)[: nb - 2]
                        for _ in range(num_heads)]
        else:
            per_head = _rand_mask_with_plan(seq_len, block_size, r, num_heads, rs)
        out[layer] = np.stack(per_head, axis=0)
    return out


# ---------------------------------------------------------------------------
# the middle query blocks: plain versions
# ---------------------------------------------------------------------------

def _slot_blocks(nb: int, rand_attn: torch.Tensor) -> torch.Tensor:
    """(H, nb-2, 5+r) key block of every slot [g0 | i-1, i, i+1 | g_last |
    random] of middle query block i = j+1."""
    H, n_mid, _ = rand_attn.shape
    j = torch.arange(n_mid, device=rand_attn.device)
    fixed = torch.stack([torch.zeros_like(j), j, j + 1, j + 2, torch.full_like(j, nb - 1)], -1)
    return torch.cat([fixed.expand(H, n_mid, 5), rand_attn.long()], -1)


def _blocked(t: torch.Tensor, bs: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, nb, bs, D)."""
    B, S, H, D = t.shape
    return t.reshape(B, S // bs, bs, H, D).permute(0, 3, 1, 2, 4)


def _mid_operands(q, k, v, mask, rand_attn, bs):
    """The plain versions' gathers: mid query blocks (B, H, n, bs, D),
    slot keys and values (B, H, n, W, D), slot penalties (B, H, n, 1, W)
    and the slot block ids."""
    B, S, H, D = q.shape
    nb = S // bs
    idx = _slot_blocks(nb, rand_attn)                    # (H, n, 5+r)
    n_mid, slots = idx.shape[1], idx.shape[2]
    hix = torch.arange(H, device=q.device)[:, None, None]
    qm = _blocked(q, bs)[:, :, 1:-1]
    kc = _blocked(k, bs)[:, hix, idx].reshape(B, H, n_mid, slots * bs, D)
    vc = _blocked(v, bs)[:, hix, idx].reshape(B, H, n_mid, slots * bs, D)
    gm = mask.float().reshape(B, nb, bs)[:, idx].clone()  # (B, H, n, 5+r, bs)
    gm[:, :, 0, 1] = 0.0           # query block 1: window block 0 is g0
    gm[:, :, n_mid - 1, 3] = 0.0   # query block nb-2: window block nb-1 is g_last
    pen = ((1.0 - gm) * ATTN_PENALTY).reshape(B, H, n_mid, 1, slots * bs)
    return qm, kc, vc, pen, idx


def _scale_in(dt, D: int) -> torch.Tensor:
    """1/√D in the compute dtype: JAX multiplies an array by a (weakly
    typed) Python float in the array's dtype, so the scale is rounded to
    it (0.1767578125 in bf16 at D=32)."""
    return torch.tensor(1.0 / math.sqrt(D), dtype=dt)


def _mid_logits(qm, kc, pen, dt):
    """Masked fp32 logits as ``_mid_logits``: the product rounded to the
    compute dtype, times 1/√D in it (rounded again), plus the fp32
    penalty."""
    f = torch.float32
    s = torch.einsum("bhjqd,bhjkd->bhjqk", qm.to(f), kc.to(f)).to(dt)
    return (s * _scale_in(dt, qm.shape[-1])).to(f) + pen


def bigbird_mid_fwd_plain(q, k, v, mask, rand_attn, block_size):
    """Plain PyTorch version of the forward kernel.

    q, k, v (B, S, H, D); mask (B, S); rand_attn (H, nb-2, r).  Returns
    (ctx (B, (nb-2)·bs, H, D) in q's dtype, lse (B, H, (nb-2)·bs) fp32)."""
    B, S, H, D = q.shape
    f = torch.float32
    qm, kc, vc, pen, _ = _mid_operands(q, k, v, mask, rand_attn, block_size)
    logits = _mid_logits(qm, kc, pen, q.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    denom = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom))[..., 0]
    w = (e / denom).to(q.dtype)
    ctx = torch.einsum("bhjqk,bhjkd->bhjqd", w.to(f), vc.to(f)).to(q.dtype)
    n = qm.shape[2] * block_size
    return (ctx.permute(0, 2, 3, 1, 4).reshape(B, n, H, D).contiguous(),
            lse.reshape(B, H, n).contiguous())


def bigbird_mid_bwd_plain(q, k, v, mask, rand_attn, block_size, out, lse, dout):
    """Plain PyTorch version of the backward kernel.

    ``out`` and ``dout`` are (B, (nb-2)·bs, H, D), ``lse`` (B, H,
    (nb-2)·bs).  Returns (dq, dk, dv), each (B, S, H, D) in q's dtype; dq
    is zero on the first and last query blocks (their gradient comes from
    the dense rows)."""
    B, S, H, D = q.shape
    bs = block_size
    nb = S // bs
    f = torch.float32
    scale = 1.0 / math.sqrt(D)
    qm, kc, vc, pen, idx = _mid_operands(q, k, v, mask, rand_attn, bs)
    n_mid, slots = idx.shape[1], idx.shape[2]
    blocked = lambda t: _blocked(t.to(q.dtype), bs).to(f)  # noqa: E731
    do, o = blocked(dout), blocked(out)                     # (B, H, n, bs, D)
    p = torch.exp(_mid_logits(qm, kc, pen, q.dtype) - lse.reshape(B, H, n_mid, bs, 1))
    dp = torch.einsum("bhjqd,bhjkd->bhjqk", do, vc.to(f))
    row = (do * o).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row)) * scale
    dq_mid = torch.einsum("bhjqk,bhjkd->bhjqd", ds, kc.to(f)).to(q.dtype)
    dkc = torch.einsum("bhjqk,bhjqd->bhjkd", ds, qm.to(f))
    dvc = torch.einsum("bhjqk,bhjqd->bhjkd", p.to(q.dtype).to(f), do)

    def scatter(c):
        acc = torch.zeros(B, H, nb, bs, D, dtype=f, device=q.device)
        bix = torch.arange(B, device=q.device)[:, None, None, None]
        hix = torch.arange(H, device=q.device)[None, :, None, None]
        acc.index_put_((bix, hix, idx[None]), c.reshape(B, H, n_mid, slots, bs, D),
                       accumulate=True)
        return acc.permute(0, 2, 3, 1, 4).reshape(B, S, H, D)

    dq = torch.zeros(B, S, H, D, dtype=q.dtype, device=q.device)
    dq[:, bs:S - bs] = dq_mid.permute(0, 2, 3, 1, 4).reshape(B, n_mid * bs, H, D)
    return dq, scatter(dkc).to(k.dtype), scatter(dvc).to(v.dtype)


# ---------------------------------------------------------------------------
# the middle query blocks: kernel wrappers
# ---------------------------------------------------------------------------

def _geometry(q, k, v, mask, rand_attn, block_size) -> Tuple[int, int, int, int, int]:
    """(B, S, H, nb, r), checked against every argument."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    B, S, H, D = q.shape
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError("q, k and v must share shape and dtype")
    if block_size < 1:
        raise ValueError(f"the block size must be at least 1, got {block_size}")
    if S % block_size:
        raise ValueError(f"S={S} is not a multiple of the block size {block_size}")
    nb = S // block_size
    if nb < KERNEL_MIN_BLOCKS:
        raise ValueError(f"block-sparse attention needs at least 5 blocks, got {nb}")
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"mask must be (B, S) = {(B, S)}, got {tuple(mask.shape)}")
    if rand_attn.dim() != 3 or tuple(rand_attn.shape[:2]) != (H, nb - 2):
        raise ValueError(f"rand_attn must be (H, nb-2, r) = ({H}, {nb - 2}, r), "
                         f"got {tuple(rand_attn.shape)}")
    return B, S, H, nb, int(rand_attn.shape[2])


def bigbird_kernel_takes(block_size: int, D: int, S: Optional[int] = None) -> bool:
    """Whether the card's BigBird kernel pair (forward and backward, fp32
    and bf16) takes block size ``block_size`` and head width ``D`` (and,
    given, a sequence of ``S`` rows): any D and block size from 1, S a
    multiple of the block size of at least 5 blocks."""
    takes = D >= 1 and block_size >= 1
    if S is not None:
        takes = takes and S % block_size == 0 and S // block_size >= KERNEL_MIN_BLOCKS
    return takes


def _check_cuda(what: str, q, tensors, block_size: int) -> None:
    """Raise unless the CUDA kernels take these arguments: fp32 or bf16 q
    at a head width and block size :func:`bigbird_kernel_takes` takes,
    every tensor on q's card."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {q.dtype}")
    if not bigbird_kernel_takes(block_size, q.shape[-1], q.shape[1]):
        raise ValueError(f"{what} kernel takes any D and block size from 1 with at least "
                         f"{KERNEL_MIN_BLOCKS} blocks, got D={q.shape[-1]}, block size "
                         f"{block_size}, S={q.shape[1]}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: tensors on different devices")


def tma_map_args(t: torch.Tensor):
    """The 4-D TMA tensor map the Hopper kernels build over a (B, S, H, D)
    view from its strides (``csrc/bigbird_sm90.cuh::make_map_bshd``): dims
    (D, H, S, B) innermost first, the byte strides of dims 1-3 and the box
    (D, 1, 64, 1), one 64-row tile at every block size; None where a map
    cannot take the view (a last stride other than 1, or a byte stride
    that is not a multiple of 16 or not below 2**40)."""
    B, S, H, D = t.shape
    sb, ss, sh, sd = t.stride()
    strides = tuple(x * t.element_size() for x in (sh, ss, sb))
    if sd != 1 or any(x % 16 or x >= 2 ** 40 for x in strides):
        return None
    return (D, H, S, B), strides, (D, 1, KERNEL_TILE, 1)


def _strided_qkv(q, k, v):
    """q, k, v at a head width that is a multiple of 8 (:func:`_pad_heads`),
    sharing one (B, S, H, D) stride set that the kernels' tensor maps take
    (copies only where they do not); returns them and the strides (sb, ss,
    sh) in elements."""
    q, k, v = _pad_heads(q, k, v)
    if not (tma_map_args(q) is not None and k.stride() == q.stride()
            and v.stride() == q.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v, q.stride()[:3]


# the widest head width of the Hopper pair's instances; the bf16 forward
# past it runs bigbird_fwd_wide_sm90_kernel, and past WIDE_ONE_LAUNCH_HEAD_DIM
# (one output part of 128 columns) with a statistics launch of its own; the
# bf16 backward past it runs bigbird_bwd_wide_sm90_kernel
MAX_INSTANCE_HEAD_DIM = 64
WIDE_ONE_LAUNCH_HEAD_DIM = 128


def _wide_stats(q: torch.Tensor, n_rows: int) -> Optional[torch.Tensor]:
    """The statistics scratch of the bf16 forward past
    ``WIDE_ONE_LAUNCH_HEAD_DIM`` for the (padded) ``q`` and ``n_rows``
    middle rows: (B, H, n_rows, 2) fp32 for each row's (m, 1/l), or None."""
    B, _, H, D = q.shape
    if q.dtype != torch.bfloat16 or D <= WIDE_ONE_LAUNCH_HEAD_DIM:
        return None
    return torch.empty((B, H, n_rows, 2), dtype=torch.float32, device=q.device)


def wide_forward_calls() -> int:
    """How many calls of :func:`bigbird_mid_fwd` ran the bf16 forward past
    ``MAX_INSTANCE_HEAD_DIM`` (``bigbird_fwd_wide_sm90_kernel``) in this
    process, as the kernels' library counts them (builds it on first use)."""
    return _build.load("bigbird_sparse", _SIGNATURES).bigbird_mid_fwd_wide_calls()


def wide_backward_calls() -> int:
    """How many calls of :func:`bigbird_mid_bwd` ran the bf16 backward past
    ``MAX_INSTANCE_HEAD_DIM`` (``bigbird_bwd_wide_sm90_kernel``) in this
    process, as the kernels' library counts them (builds it on first use)."""
    return _build.load("bigbird_sparse", _SIGNATURES).bigbird_mid_bwd_wide_calls()


def bigbird_mid_fwd(q, k, v, mask, rand_attn, block_size):
    """Middle query blocks of block-sparse attention: (ctx, lse), as
    :func:`bigbird_mid_fwd_plain`.  q, k, v (B, S, H, D) may be strided
    views (the last axis contiguous).

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    B, S, H, nb, r = _geometry(q, k, v, mask, rand_attn, block_size)
    if q.device.type == "cpu":
        return bigbird_mid_fwd_plain(q, k, v, mask, rand_attn, block_size)
    _check_cuda("bigbird_mid_fwd", q, (k, v, mask, rand_attn), block_size)
    D = q.shape[3]
    q, k, v, (sb, ss, sh) = _strided_qkv(q, k, v)
    maskf = mask.float().contiguous()
    rand = rand_attn.to(torch.int32).contiguous()
    n = (nb - 2) * block_size
    out = torch.empty((B, n, H, q.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, n), dtype=torch.float32, device=q.device)
    stats = _wide_stats(q, n)
    _build.check_aligned("bigbird_mid_fwd", q, k, v, out)
    if B == 0 or H == 0:
        return _unpad(D, out)[0], lse
    lib = _build.load("bigbird_sparse", _SIGNATURES)
    status = lib.bigbird_mid_fwd(
        _DTYPES[q.dtype], *(_build.ptr(t) for t in (q, k, v, maskf, rand, out, lse, stats)),
        B, S, H, r, block_size, q.shape[3], sb, ss, sh, 1.0 / math.sqrt(D),
        _build.stream(q.device))
    _build.check(status, "bigbird_mid_fwd")
    bigbird_mid_fwd.launches += 1
    return _unpad(D, out)[0], lse


bigbird_mid_fwd.launches = 0


def bigbird_mid_bwd(q, k, v, mask, rand_attn, block_size, out, lse, dout):
    """Gradients of the middle query blocks: (dq, dk, dv), as
    :func:`bigbird_mid_bwd_plain`; ``dout`` in q's dtype.

    A tensor on the CPU takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    B, S, H, nb, r = _geometry(q, k, v, mask, rand_attn, block_size)
    if q.device.type == "cpu":
        return bigbird_mid_bwd_plain(q, k, v, mask, rand_attn, block_size, out, lse, dout)
    _check_cuda("bigbird_mid_bwd", q, (k, v, mask, rand_attn, out, lse, dout), block_size)
    n = (nb - 2) * block_size
    D = q.shape[3]
    if (tuple(out.shape) != (B, n, H, D) or dout.shape != out.shape
            or out.dtype != q.dtype or dout.dtype != q.dtype):
        raise ValueError(f"out and dout must be ({B}, {n}, {H}, {D}) in {q.dtype}")
    if tuple(lse.shape) != (B, H, n) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 ({B}, {H}, {n})")
    q, k, v, (sb, ss, sh) = _strided_qkv(q, k, v)
    out, dout = (t.contiguous() for t in _pad_heads(out, dout))
    lse = lse.contiguous()
    maskf = mask.float().contiguous()
    rand = rand_attn.to(torch.int32).contiguous()
    Dp = q.shape[3]
    dq = torch.zeros((B, S, H, Dp), dtype=q.dtype, device=q.device)
    dk = torch.zeros((B, S, H, Dp), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    _build.check_aligned("bigbird_mid_bwd", q, k, v, out, dout, dq, dk, dv)
    if B == 0 or H == 0:
        return _unpad(D, dq, dk.to(q.dtype), dv.to(q.dtype))
    lib = _build.load("bigbird_sparse", _SIGNATURES)
    status = lib.bigbird_mid_bwd(
        _DTYPES[q.dtype],
        *(_build.ptr(t) for t in (q, k, v, maskf, rand, out, lse, dout, dq, dk, dv)),
        B, S, H, r, block_size, Dp, sb, ss, sh, 1.0 / math.sqrt(D), _build.stream(q.device))
    _build.check(status, "bigbird_mid_bwd")
    bigbird_mid_bwd.launches += 1
    return _unpad(D, dq, dk.to(q.dtype), dv.to(q.dtype))


bigbird_mid_bwd.launches = 0


class _MidBlocks(torch.autograd.Function):
    """The kernel pair as one autograd function; it saves what the JAX
    custom VJP saves: q, k, v, the mask, the plan, the output and lse.
    No gradient reaches the mask or the plan."""

    @staticmethod
    def forward(ctx, q, k, v, mask, rand_attn, block_size):
        out, lse = bigbird_mid_fwd(q, k, v, mask, rand_attn, block_size)
        ctx.save_for_backward(q, k, v, mask, rand_attn, out, lse)
        ctx.block_size = block_size
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, rand_attn, out, lse = ctx.saved_tensors
        dq, dk, dv = bigbird_mid_bwd(q, k, v, mask, rand_attn, ctx.block_size, out, lse,
                                     g.to(q.dtype).contiguous())
        return dq, dk, dv, None, None, None


def plan_to_device(rand_attn, nb: int, device) -> torch.Tensor:
    """A random-block plan (numpy or tensor, any leading axes) as int32 on
    ``device``.  A numpy plan must hold block ids in [0, nb); it goes to a
    card from pinned memory without blocking the host, so a forward keeps
    its launches queued."""
    if torch.is_tensor(rand_attn):
        return rand_attn.to(device=device, dtype=torch.int32)
    plan = np.array(rand_attn, np.int32)
    if plan.size and (plan.min() < 0 or plan.max() >= nb):
        raise ValueError(f"rand_attn block ids must lie in [0, {nb})")
    t = torch.from_numpy(plan)
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def block_sparse_attention(
    q: torch.Tensor,            # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    rand_attn,                  # (H, nb-2, r) int plan, numpy or tensor
    attention_mask: torch.Tensor,  # (B, S) 0/1
    block_size: int,
) -> torch.Tensor:
    """(B, H, S, D) context with HF's block-sparse semantics, structured as
    the JAX package's ``block_sparse_attention_pallas``: the middle query
    blocks through the kernel pair, the first and last query blocks as
    dense rows in plain PyTorch, the context times the query mask.

    Differentiable in q, k and v; the (B, H, S, D) arguments may be views
    of (B, S, H, D) tensors, which the kernels read with their strides."""
    B, H, S, D = q.shape
    bs = block_size
    rand = plan_to_device(rand_attn, S // bs, q.device)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))   # (B, S, H, D) views
    mask = attention_mask.to(device=q.device, dtype=torch.float32)
    ctx_mid = _MidBlocks.apply(qs, ks, vs, mask, rand, bs)

    penalty = ((1.0 - mask) * ATTN_PENALTY)[:, None, None, :]   # (B, 1, 1, S)
    scale = _scale_in(q.dtype, D)

    def dense_block(qb):   # (B, bs, H, D) -> (B, bs, H, D)
        s = torch.einsum("bqhd,bkhd->bhqk", qb, ks) * scale
        w = torch.softmax(s.float() + penalty, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, vs)

    ctx = torch.cat([dense_block(qs[:, :bs]), ctx_mid, dense_block(qs[:, S - bs:])], dim=1)
    ctx = ctx * mask[:, :, None, None].to(ctx.dtype)
    return ctx.transpose(1, 2)
