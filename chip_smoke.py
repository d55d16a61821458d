"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: the card's name and power limit (nvidia-smi); CUDA must exist;
2. build: every CUDA source of ``stonkgs_tpu_torch/csrc`` with nvcc, all
   started together, with ptxas's register and spill report (fatal if any
   Hopper kernel spills: the attention forward and backward, the FFN
   block's GEMM and LayerNorm passes, the training FFN's GEMMs and dual
   GEMM, the BigBird forward and backward, the int8 dense's row-quantize
   pass and the int8 GEMM of the dense and the probe);
3. kernels: the serving kernels against their plain PyTorch versions on
   the card, in bf16 and fp32, at the serving paths' shapes (the FFN
   block at H=768 with gelu and gelu_new and at ProtBERT's H=1024, at
   M = 0, 1, 3, 127, 128, 129, 1,000, 6,144, 24,576, 32,768 and 65,536;
   attention up to S=1024 and at ProtBERT's S=3072 with 16 heads), then
   the bf16 attention at the edges of its 128-row tiles (S = 63, 64, 65,
   127, 128, 129, 200, 3000; B=H=1 and B=8; masked, unmasked, and a row
   whose keys are all at -1e9); bf16 attention outputs are also held
   within one bf16 step of the output's scale (``ATTN_STEP``), and at
   S=3000 that limit must reject the plain output without one key tile;
4. training kernels: the attention forward (rate 0 and 0.1, S = 1, 129,
   260, 300, 512, 1024, and S=3072 with 16 heads, where the output limit
   must reject a missing keep scale), the attention backward (rates 0 and
   0.1, with and without db, S = 1, 63, 64, 65, 127, 128, 129, 260, 300,
   512 and 1024, at B=H=1 and at the step's B=32 H=12, masked, unmasked
   and with a row whose keys are all at -1e9; bf16 gradients also within
   ``ATTN_STEP`` of their scale, a limit that must reject dK without its
   scale and dV without the keep scale) and the FFN pair (M = 0, 1, 3,
   127, 128, 129, 1,000, 8,192, 16,384 with gelu and gelu_new; bf16 at
   I=1000; H=1024 at M = 3 and 6,144; the bf16 dh limit must reject a dh
   whose gelu' lacks its h-dependent term), against their plain versions,
   in bf16 and fp32;
5. serving: ``STonKGsEngine.embed`` at full BERT-base width (backbone and
   trunk, 256 + 256, KG vocabulary 100,000, random seeded weights) on 512
   rows, in parity mode and with ``length_buckets=(64, 128)``; checks the
   kernels' launch counts, finite output, the card in fp32 against the
   CPU in fp32, and the card in bf16 against the CPU in fp32;
6. timing: embed throughput, and each serving kernel's time at the path's
   shapes beside its bound, its plain version and PyTorch's SDPA (for
   attention also its TFLOP/s and its time as a multiple of SDPA's; for
   the FFN block the two cuBLAS products it contains, timed alone);
7. training: ``pretrain`` at full width (B=32, fp32 parameters, bf16
   compute, synthetic batches with int(0.15*len) masked positions per
   half); checks the training kernels' launch counts, a finite loss at
   every step, the frozen backbones bit-unchanged and the trainable
   parameters changed;
8. training numerics: the loss and trunk gradients on the card in fp32
   against the CPU in fp32 (2 rows, 2 layers, attention dropout 0.1 with
   the same seeds, hidden dropout 0), then on the card in bf16 through
   the Hopper kernels against the same CPU fp32 run (loss within 1e-2
   relative, every gradient leaf at a cosine of at least 0.99);
9. training timing: ms per step and examples/s (median of 6 steps after 2
   of warm-up), and each training kernel's time at the step's shapes
   beside its bound, its plain version and, for attention, SDPA (the
   backward: ``torch.autograd.grad`` alone over a saved SDPA forward,
   with the backend that ran), for the FFN pair the cuBLAS products it
   contains, timed alone;
10. sparse kernels: the BigBird pair against its plain versions, bf16 and
    fp32, at nb = 5, 8 (padded mask) and 64 (S=4096), with the eval and
    the training plan, at B=2 (forward and backward) and B=8 (forward);
    bf16 contexts also within ``ATTN_STEP`` of their scale, bf16
    gradients within it plus ``GRAD_STEP_FLOOR``; at S=4096 the limits
    must reject a context without one random slot, a context without the
    duplicate window slot's penalty and dK without the g0 slot's adds;
11. ProtSTonKGs serving: ``ProtSTonKGsEngine.embed`` at full width
    (BigBird trunk 12 x 768, BioBERT 12 x 768, ProtBERT 30 x 1024, KG
    vocabulary 20,000, seeded random weights) on 32 rows at B=8; checks
    the launch counts, finite output, and, at 2 layers a stack, the card
    in fp32 and bf16 against the CPU in fp32;
12. ProtSTonKGs training: ``pretrain(..., loss_fn=protstonkgs.
    pretraining_loss)`` at full width (B=2, 4 steps, the training plan);
    checks the launch counts, finite losses, the three backbones
    bit-unchanged and the trunk and projection trained;
13. ProtSTonKGs training numerics: loss and gradients, card fp32 against
    CPU fp32, at 2 layers a stack (hidden dropout 0, the backbones'
    attention dropout 0.1 on the same seeds);
14. ProtSTonKGs timing: embed sequences/s, ms per step (median of 6 after
    2), and each new or widened kernel at the path's shapes beside its
    bound and its plain version (the training FFN pair at ProtBERT's,
    the BigBird trunk's and BioBERT's shapes; the BigBird pair also
    beside its floor and SDPA over operands gathered beforehand, its
    backward alone over a saved forward);
15. int8 kernels: the fused int8 dense against its plain version, bf16
    and fp32, at every shape of the int8 serving paths, at M = 0, 1 and
    300, an all-zero row, N = 100, the decoders' N = 28,996 and 100,000,
    K = 48 and 784 (K % 32 == 16), a strided ``x[:, :1]`` and a
    row-major weight (copied for the call); its row-quantize pass's codes
    and scales equal to ``quantize_rows`` bit for bit at every shape; the
    limits shown to reject codes made with a reciprocal and an epilogue
    without s_w; the int8 GEMM probe exactly equal to its plain version
    at 512 x 1024 x 512 and 4096^3, bf16 within tolerance;
16. int8 serving: ``quantize_params`` on phase 5's parameters, then
    ``STonKGsEngine.embed`` on 512 rows at B=128 in bf16; checks the
    launch counts (144 int8 denses, 23 attentions, no FFN block a batch),
    every quantized weight of the engine column-major (the kernel reads
    it without a copy), finite output, card fp32 against CPU fp32 (both
    int8; cosine 0.9999 at 2 layers a stack; at full depth each layer fed
    the CPU's input, cosine 0.9999 and at most 1e-3 of its activation
    codes flipped, where the bf16 control must flip more; end to end
    0.999 against gross faults) and card bf16 against CPU fp32; int8 and
    bf16 pairs/s in turns;
17. ProtSTonKGs int8 serving: the same with ``ProtSTonKGsEngine`` at full
    width on 32 rows at B=8 (325 int8 denses, 42 attentions, 11 sparse
    a batch) and at 2 layers a stack against the CPU; sequences/s in
    turns with bf16;
18. int8 timing: the int8 dense at each path shape beside its bound, its
    plain version, ``torch._int_mm`` on codes made beforehand (with the
    column-major weight) and the bf16 dense it replaces, and its two
    launches timed apart, each beside its own bound (the pass by bytes,
    the GEMM by bytes or operations; their sum is the design's floor);
    the probe's ``main`` (its exactness checks,
    then ``torch.mm`` bf16, ``torch._int_mm`` and the kernel on int8 and
    on bf16 at 4096^3, in TFLOP/s).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from stonkgs_tpu_torch import ProtSTonKGsEngine, STonKGsEngine
from stonkgs_tpu_torch.config import BertConfig, BigBirdConfig, ProtSTonKGsConfig, STonKGsConfig
from stonkgs_tpu_torch.models import bert, protstonkgs, stonkgs
from stonkgs_tpu_torch.ops import _build
from stonkgs_tpu_torch.ops.bigbird_sparse import (
    _blocked,
    _mid_logits,
    _mid_operands,
    bigbird_mid_bwd,
    bigbird_mid_bwd_plain,
    bigbird_mid_fwd,
    bigbird_mid_fwd_plain,
    build_rand_attn,
)
from stonkgs_tpu_torch.ops.flash_attention import (
    flash_attention_infer,
    flash_attention_infer_plain,
)
from stonkgs_tpu_torch.ops.flash_attention import (
    flash_attention_train_bwd,
    flash_attention_train_bwd_plain,
    flash_attention_train_fwd,
    flash_attention_train_fwd_plain,
)
from stonkgs_tpu_torch.ops.fused_ffn import (
    BWD_HIDDEN,
    fused_ffn_bwd,
    fused_ffn_bwd_plain,
    fused_ffn_fwd,
    fused_ffn_ln_block,
    fused_ffn_ln_block_plain,
    fused_ffn_plain,
)
from stonkgs_tpu_torch.ops.quantization import (
    _dequant_plain,
    dense_int8_fused,
    dense_int8_fused_plain,
    dense_int8_gemm,
    dense_int8_quantize,
    is_quantized,
    k_major,
    quantize_kernel,
    quantize_params,
    quantize_rows,
)
from stonkgs_tpu_torch.benchmarks import bench_int8_gemm
from stonkgs_tpu_torch.benchmarks.bigbird_sdpa import gathered_operands, sdpa_mid, to_ctx
from stonkgs_tpu_torch.benchmarks._util import time_ms
from stonkgs_tpu_torch.benchmarks.bench_int8_gemm import int8_gemm, int8_gemm_plain
from stonkgs_tpu_torch.train import pretraining
from stonkgs_tpu_torch.train.optimizer import AdamW, split_frozen
from stonkgs_tpu_torch.utils.convert import params_to
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

DEV = "cuda"
BF16 = torch.bfloat16
F32 = torch.float32
I8 = torch.int8
# H100 SXM data-sheet peaks (dense): tensor-core bf16 and int8, fp32
# outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {BF16: 989e12, F32: 67e12, I8: 1979e12}
HBM_BYTES_PER_S = 3.35e12
# the SFU's exp rate: 16 ex2 a clock on each of 132 SMs at 1.98 GHz
EX2_PER_S = 132 * 16 * 1.98e9
# kernel vs plain on the card: fp32 sums run in another order; bf16 may
# round an intermediate or the output to the other neighbour (one bf16
# step is 2^-7 relative)
TOL = {F32: dict(atol=1e-4, rtol=0.0), BF16: dict(atol=2e-2, rtol=1e-2)}
# the bf16 attention output, besides TOL, elementwise within one bf16 step
# (2^-7) of max |plain| plus one step of itself: at long S the output is
# small (rms about sqrt(e / S), 0.03 at S=3072), where TOL's atol alone
# would pass a missing dropout keep scale or a dropped key tile.  The bf16
# attention gradients are held to the same elementwise limit besides
# GRAD_TOL (which holds only the largest error against the largest value),
# plus GRAD_STEP_FLOOR: a gradient that cancels to 0 in the plain version
# (S=1: one key, so dS = p (dP - delta) = 0) comes out at the fp32
# rounding level
ATTN_STEP = 2.0 ** -7
GRAD_STEP_FLOOR = 1e-4
# gradients and backward outputs are sums over up to 1,024 rows of
# products of rounded operands, so their error grows with their size:
# the tolerance is relative to the largest value (fp32: sums in another
# order; bf16: an operand rounded to the other neighbour, one step 2^-8)
GRAD_TOL = {F32: 1e-4, BF16: 2e-2}
# the int8 dense in fp32 against its plain version: the same codes and
# the same rounded epilogue, so equal up to 1e-6 of the largest output
INT8_F32_TOL = 1e-6
SOURCES = ("ffn_ln_block", "flash_attention_infer", "flash_attention_train", "ffn_train",
           "bigbird_sparse", "dense_int8", "int8_gemm")
# the Hopper (wgmma, TMA) kernels of each library, which must not spill
SM90_KERNELS = {
    "flash_attention_infer": ("attn_fwd_sm90_kernel",),
    "flash_attention_train": ("attn_fwd_sm90_kernel", "attn_bwd_dq_sm90_kernel",
                              "attn_bwd_dkdv_sm90_kernel"),
    "ffn_ln_block": ("gemm_sm90_kernel", "add_layer_norm_kernel"),
    "ffn_train": ("gemm_sm90_kernel", "ffn_bwd_dual_sm90_kernel"),
    "bigbird_sparse": ("bigbird_fwd_sm90_kernel", "bigbird_bwd_sm90_kernel"),
    "dense_int8": ("quantize_rows_kernel", "gemm_kmajor_sm90_kernel"),
    "int8_gemm": ("gemm_kmajor_sm90_kernel",),
}
# rows of the FFN block's checks: empty, ragged, the edges of the 128-row
# tile, the ProtSTonKGs BioBERT (6,144) and ProtBERT (24,576) shapes, the
# STonKGs backbone and BigBird trunk (32,768) and the STonKGs trunk
FFN_ROWS = (0, 1, 3, 127, 128, 129, 1000, 6144, 24576, 32768, 65536)
# rows of the training FFN pair's checks: empty, ragged, the edges of the
# 128-row tile, and the STonKGs step's backbone and trunk
TRAIN_FFN_ROWS = (0, 1, 3, 127, 128, 129, 1000, 8192, 16384)
# sequence lengths of the attention backward's checks: one key, the edges
# of the 64- and 128-row tiles, TransE's 260, S_pad > S (300), and the
# paths' 512 and 1024
ATTN_BWD_S = (1, 63, 64, 65, 127, 128, 129, 260, 300, 512, 1024)
BATCH = 128
ROWS = 512
BUCKETS = (64, 128)
TRAIN_BATCH = 32
TRAIN_STEPS = 4      # steps of the pretrain run whose launches are counted
ATTN_RATE = 0.1      # the model's attention dropout


class SmokeFailure(Exception):
    """A phase found the port wrong or missing on the card."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    log(f"# build: {time.perf_counter() - t0:.1f} s for {len(SOURCES)} sources "
        f"(nvcc in parallel)")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"# ptxas {name}: {line.strip()}")
    # no Hopper kernel may spill (every instantiation)
    for name, kernels in SM90_KERNELS.items():
        if name not in _build.build_logs:
            log(f"# ptxas {name}: library not rebuilt, no report to check")
            continue
        spills = _ptxas_spills(_build.build_logs[name])
        for kernel in kernels:
            found = {f: n for f, n in spills.items() if kernel in f}
            check(bool(found), f"{name}: no ptxas report for {kernel}")
            for fn, (stores, loads) in found.items():
                check(stores == 0 and loads == 0,
                      f"{name}: {fn} spills ({stores} bytes stored, {loads} loaded)")
            log(f"# ptxas {name}: {kernel} x{len(found)} without spills")


def _ptxas_spills(text: str) -> dict:
    """{function: (spill store bytes, spill load bytes)} from ptxas -v."""
    spills, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return spills


def _bias(B: int, S: int, gen: torch.Generator) -> tuple:
    """Random right-padding: (B, 1, 1, S) fp32 key bias and (B, S) keep mask."""
    lengths = torch.randint(1, S + 1, (B,), generator=gen)
    keep = torch.arange(S)[None, :] < lengths[:, None]
    bias = ((1.0 - keep.float()) * -1e9)[:, None, None, :]
    return bias.to(DEV), keep.to(DEV)


def _attn_inputs(B, S, dtype, gen, masked=True, H=12, D=64):
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(DEV, dtype) for _ in range(3))
    bias, keep = _bias(B, S, gen) if masked else (None, None)
    return q, k, v, bias, keep


def _ffn_inputs(M, dtype, gen, H=768, I=3072):
    """x, attn_out, LN1, W1, b1, W2, b2, LN2 of the serving block (fp32
    vectors, weights in dtype)."""
    def n(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen)).to(DEV)
    return [n(M, H).to(dtype), n(M, H).to(dtype),
            n(H, std=0.1, mean=1.0), n(H, std=0.1),
            n(H, I, std=0.02).to(dtype), n(I, std=0.02),
            n(I, H, std=0.02).to(dtype), n(H, std=0.02),
            n(H, std=0.1, mean=1.0), n(H, std=0.1)]


def _compare(name, got, want, dtype) -> float:
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    tol = TOL[dtype]
    ok = bool(torch.allclose(g, w, **tol))
    log(f"# check {name}: max_abs_err {err!r} tol atol={tol['atol']} "
        f"rtol={tol['rtol']} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def _attn_within(got, want, floor: float = 0.0) -> tuple:
    """(max |got - want|, max |want|, ok) under the ATTN_STEP limit (plus
    ``floor``)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) if w.numel() else 0.0
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(((g - w).abs() <= ATTN_STEP * (scale + w.abs()) + floor).all())
    return err, scale, ok


def _compare_attn(name, got, want, dtype) -> float:
    """An attention output: TOL, and for bf16 also the ATTN_STEP limit."""
    err = _compare(name, got, want, dtype)
    if dtype == BF16:
        _, scale, ok = _attn_within(got, want)
        log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} limit "
            f"{ATTN_STEP!r}*(max|plain|+|plain|) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: kernel disagrees with its plain version (scaled limit)")
    return err


def _attn_limit_rejects(name, want, wrong) -> None:
    """Fail unless the ATTN_STEP limit tells ``wrong`` (a known kernel
    fault applied to the plain output) from ``want``."""
    err, scale, ok = _attn_within(wrong, want)
    log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} "
        f"{'passes: FAIL' if ok else 'rejected: ok'}")
    check(not ok, f"{name}: the attention limit does not catch this fault")


def _compare_rel(name, got, want, dtype) -> float:
    """got vs want within GRAD_TOL[dtype] times max(1, max |want|)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    limit = GRAD_TOL[dtype] * max(1.0, scale)
    ok = err <= limit
    log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} limit {limit!r} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def phase_kernels() -> dict:
    """Kernel vs plain version on the card; returns the bf16 errors at the
    largest path shape of each kernel."""
    gen = torch.Generator().manual_seed(1)
    errs = {}
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for S in (1, 256, 260, 320, 384, 512, 1024):
            for masked in (True, False):
                q, k, v, bias, _ = _attn_inputs(8, S, dtype, gen, masked)
                err = _compare_attn(
                    f"attention {tag} B=8 S={S} {'mask' if masked else 'no-bias'}",
                    flash_attention_infer(q, k, v, bias),
                    flash_attention_infer_plain(q, k, v, bias), dtype)
                if dtype == BF16 and S == 512:
                    errs["flash_attention_infer"] = max(
                        errs.get("flash_attention_infer", 0.0), err)
        # BERT-base (gelu), the BigBird trunk (gelu_new), ProtBERT (H=1024),
        # at the edges of the 128-row tiles and at the paths' M
        for H, I, act in ((768, 3072, "gelu"), (768, 3072, "gelu_new"), (1024, 4096, "gelu")):
            for M in FFN_ROWS:
                args = _ffn_inputs(M, dtype, gen, H, I)
                err = _compare(
                    f"ffn_ln {tag} H={H} M={M} {act}",
                    fused_ffn_ln_block(*args, act=act),
                    fused_ffn_ln_block_plain(*args, act=act), dtype)
                if dtype == BF16 and M >= 24576:
                    errs["ffn_ln_block"] = max(errs.get("ffn_ln_block", 0.0), err)
                del args
        # ProtBERT's attention: S=3072, 16 heads, no mask
        q, k, v, _, _ = _attn_inputs(8, 3072, dtype, gen, masked=False, H=16)
        err = _compare_attn(f"attention {tag} B=8 S=3072 H=16 no-bias",
                       flash_attention_infer(q, k, v), flash_attention_infer_plain(q, k, v),
                       dtype)
        if dtype == BF16:
            errs["flash_attention_infer"] = max(errs["flash_attention_infer"], err)
    _attention_edges(gen)
    return errs


def _attention_edges(gen) -> None:
    """The bf16 kernel at the edges of its 128-row and 128-key tiles: S
    one under, at and one over 64 and 128, 200 and 3000; one head of one
    row and B=8 with 12 heads; masked and not, and masked with batch row
    0's keys all at -1e9 (a uniform softmax on both sides)."""
    for S in (63, 64, 65, 127, 128, 129, 200, 3000):
        for B, H in ((1, 1), (8, 12)):
            for masked in (True, False):
                q, k, v, bias, _ = _attn_inputs(B, S, BF16, gen, masked, H)
                label = f"attention bf16 edge B={B} H={H} S={S} {'mask' if masked else 'no-bias'}"
                want = flash_attention_infer_plain(q, k, v, bias)
                _compare_attn(label, flash_attention_infer(q, k, v, bias), want, BF16)
                if S == 3000 and B > 1 and not masked:
                    # the plain output with the second key tile left out
                    cut = torch.zeros(B, 1, 1, S, device=DEV)
                    cut[..., 128:256] = -1e9
                    _attn_limit_rejects(label + " without keys 128-255", want,
                                        flash_attention_infer_plain(q, k, v, cut))
                if masked and B > 1:
                    bias[0] = -1e9
                    _compare_attn(label + " row 0 all -1e9", flash_attention_infer(q, k, v, bias),
                                  flash_attention_infer_plain(q, k, v, bias), BF16)


def _train_attn_inputs(B, S, dtype, gen, masked=True, H=12):
    """q, k, v, bias, keep, a two-word seed and an output cotangent."""
    q, k, v, bias, keep = _attn_inputs(B, S, dtype, gen, masked, H)
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32, generator=gen)
    do = torch.randn(B, S, H, 64, generator=gen).to(DEV, dtype)
    return q, k, v, bias, keep, seed, do


def _compare_grad(name, got, want, dtype) -> float:
    """An attention gradient: GRAD_TOL, and for bf16 also the ATTN_STEP
    limit."""
    err = _compare_rel(name, got, want, dtype)
    if dtype == BF16:
        _, scale, ok = _attn_within(got, want, GRAD_STEP_FLOOR)
        log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r} limit "
            f"{ATTN_STEP!r}*(max|plain|+|plain|)+{GRAD_STEP_FLOOR!r} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: kernel disagrees with its plain version (scaled limit)")
    return err


def _attention_bwd_cases(tag, dtype, B, H, S, rate, gen) -> float:
    """The backward kernel against its plain version from the plain
    forward's out and lse: masked with db, masked without db, unmasked
    with db and, for B > 1, masked with batch row 0's keys all at -1e9.
    At the step's shape, bf16 and rate 0.1, it also shows that the bf16
    gradient limits reject dK without its final scale and dV without the
    keep scale.  Returns the worst gradient error."""
    worst = 0.0
    cases = [("mask db", True, True, False), ("mask no-db", True, False, False),
             ("no-bias db", False, True, False)]
    if B > 1:
        cases.append(("mask db row 0 all -1e9", True, True, True))
    for name, masked, need_db, dead_row in cases:
        q, k, v, bias, _, seed, do = _train_attn_inputs(B, S, dtype, gen, masked, H)
        if dead_row:
            bias[0] = -1e9
        out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
        got = flash_attention_train_bwd(q, k, v, bias, out_p, lse_p, do, seed, rate,
                                        need_db=need_db)
        want = flash_attention_train_bwd_plain(q, k, v, bias, out_p, lse_p, do, seed, rate,
                                               need_db=need_db)
        label = f"{tag} B={B} H={H} S={S} rate={rate} {name}"
        for n, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            worst = max(worst, _compare_grad(f"attention {n} {label}", g, w, dtype))
        check((got[3] is None) == (want[3] is None) == (not need_db), f"{label}: db presence")
        if need_db:
            worst = max(worst, _compare_rel(f"attention db {label}", got[3], want[3], F32))
        if dtype == BF16 and B > 1 and S == 512 and rate > 0 and name == "mask db":
            _grad_limit_rejects(f"attention dk {label} without the scale", want[1],
                                (want[1].float() * math.sqrt(64)).to(BF16))
            _grad_limit_rejects(f"attention dv {label} without the keep scale", want[2],
                                (want[2].float() * (1.0 - rate)).to(BF16))
        del q, k, v, bias, do, out_p, lse_p, got, want
    return worst


def _grad_limit_rejects(name, want, wrong) -> None:
    """Fail unless the bf16 gradient limits (GRAD_TOL and ATTN_STEP) tell
    ``wrong`` (a known kernel fault applied to the plain gradient) from
    ``want``; logs which of the two rejects it."""
    g, w = wrong.float(), want.float()
    err = float((g - w).abs().max())
    scale = float(w.abs().max())
    by_tol = err > GRAD_TOL[BF16] * max(1.0, scale)
    by_step = not _attn_within(wrong, want, GRAD_STEP_FLOOR)[2]
    log(f"# check {name}: max_abs_err {err!r} max|plain| {scale!r}; GRAD_TOL "
        f"{'rejects' if by_tol else 'passes'} it, ATTN_STEP {'rejects' if by_step else 'passes'} "
        f"it: {'ok' if by_tol or by_step else 'FAIL'}")
    check(by_tol or by_step, f"{name}: the gradient limits do not catch this fault")


def _train_ffn_inputs(M, dtype, gen, H=768, I=3072):
    """x, w1, b1, w2, b2 (fp32 weights, as the model's parameters) and a
    cotangent g."""
    def n(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen)).to(DEV)
    return (n(M, H).to(dtype), n(H, I, std=0.02), n(I, std=0.02), n(I, H, std=0.02),
            n(H, std=0.02), n(M, H).to(dtype))


def _train_ffn_cases(gen, note) -> None:
    """The training FFN pair against its plain versions: bf16 and fp32 at
    H=768, I=3072 at every M of TRAIN_FFN_ROWS with gelu and gelu_new;
    bf16 at I=1000 (a ragged edge of the 128-column tiles); ProtBERT's
    H=1024, I=4096 at M = 3 and 6,144 (the fp32 backward takes H=768
    only).  At M=8,192 the bf16 dh limit must reject dh whose gelu' lacks
    its h-dependent term."""
    cases = [(dtype, 768, 3072, M, act) for dtype in (BF16, F32) for M in TRAIN_FFN_ROWS
             for act in ("gelu", "gelu_new")]
    cases += [(BF16, 768, 1000, M, act) for M in (3, 129, 1000) for act in ("gelu", "gelu_new")]
    cases += [(dtype, 1024, 4096, M, "gelu") for dtype in (BF16, F32) for M in (3, 6144)]
    for dtype, H, I, M, act in cases:
        tag = "bf16" if dtype == BF16 else "fp32"
        x, w1, b1, w2, b2, g = _train_ffn_inputs(M, dtype, gen, H, I)
        label = f"{tag} H={H} I={I} M={M} {act}"
        e = _compare(f"ffn fwd {label}", fused_ffn_fwd(x, w1, b1, w2, b2, act=act),
                     fused_ffn_plain(x, w1, b1, w2, b2, act=act), dtype)
        note("ffn_train_fwd", e, dtype, (H, M) in ((768, 16384), (1024, 6144)))
        if dtype == F32 and H != BWD_HIDDEN:
            continue
        got = fused_ffn_bwd(x, g, w1, b1, w2, act=act)
        want = fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)
        e = max(_compare_rel(f"ffn dx {label}", got[0], want[0], dtype),
                _compare_rel(f"ffn dh {label}", got[1], want[1], dtype),
                _compare(f"ffn a {label}", got[2], want[2], dtype))
        note("ffn_train_bwd", e, dtype, (H, M) == (768, 16384))
        if dtype == BF16 and (H, I, M) == (768, 3072, 8192):
            _rel_limit_rejects(f"ffn dh {label} without the h-dependent term of gelu'",
                               want[1], _dh_without_h_term(x, g, w1, b1, w2, act))
        del x, w1, b1, w2, b2, g, got, want


def _dh_without_h_term(x, g, w1, b1, w2, act):
    """The plain version's dh with gelu' cut to its first term: 0.5 (1 +
    erf(h / sqrt 2)) without h phi(h), or 0.5 (1 + tanh(u)) without the
    tanh's derivative."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    if act == "gelu":
        first = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
    else:
        first = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (h + 0.044715 * h ** 3)))
    return ((g.to(dt).float() @ w2.to(dt).float().T) * first).to(dt)


def _rel_limit_rejects(name, want, wrong) -> None:
    """Fail unless ``_compare_rel``'s limit (GRAD_TOL of max(1, max
    |want|)) tells ``wrong`` (a known kernel fault applied to the plain
    output) from ``want``."""
    g, w = wrong.float(), want.float()
    err = float((g - w).abs().max())
    limit = GRAD_TOL[want.dtype] * max(1.0, float(w.abs().max()))
    log(f"# check {name}: max_abs_err {err!r} limit {limit!r} "
        f"{'passes: FAIL' if err <= limit else 'rejected: ok'}")
    check(err > limit, f"{name}: the limit does not catch this fault")


def phase_train_kernels() -> dict:
    """The training kernels vs their plain versions on the card; returns,
    per kernel, the worst bf16 error at the step's largest shape."""
    gen = torch.Generator().manual_seed(3)
    errs = {}

    def note(name, err, dtype, at_path_shape):
        if dtype == BF16 and at_path_shape:
            errs[name] = max(errs.get(name, 0.0), err)

    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for S in (1, 260, 512, 1024):
            B = 4 if S == 1024 else 8
            for rate in (0.0, ATTN_RATE):
                q, k, v, bias, _, seed, _ = _train_attn_inputs(B, S, dtype, gen)
                label = f"{tag} B={B} S={S} rate={rate}"
                out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate)
                out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                e = max(_compare_attn(f"attention fwd {label}", out, out_p, dtype),
                        _compare(f"attention lse {label}", lse, lse_p, F32))
                note("flash_attention_train_fwd", e, dtype, S == 512)
        for S in ATTN_BWD_S:
            for B, H in ((1, 1), (TRAIN_BATCH, 12)):
                for rate in (0.0, ATTN_RATE):
                    e = _attention_bwd_cases(tag, dtype, B, H, S, rate, gen)
                    note("flash_attention_train_bwd", e, dtype, S == 512 and B > 1)
        # the forward across a 128-key tile (S=129) and with the TPU
        # kernel's padded keys (S=300, S_pad=512)
        for S in (129, 300):
            for rate in (0.0, ATTN_RATE):
                q, k, v, bias, _, seed, _ = _train_attn_inputs(8, S, dtype, gen)
                label = f"{tag} B=8 S={S} rate={rate}"
                out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate)
                out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                _compare_attn(f"attention fwd {label}", out, out_p, dtype)
                _compare(f"attention lse {label}", lse, lse_p, F32)
        # ProtBERT's attention in training: S=3072, 16 heads, rate 0.1 and 0
        for rate in (ATTN_RATE, 0.0):
            q, k, v, _, _, seed, _ = _train_attn_inputs(2, 3072, dtype, gen, False, H=16)
            out, lse = flash_attention_train_fwd(q, k, v, None, seed, rate)
            out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, None, seed, rate)
            label = f"{tag} B=2 S=3072 H=16 rate={rate}"
            e = max(_compare_attn(f"attention fwd {label}", out, out_p, dtype),
                    _compare(f"attention lse {label}", lse, lse_p, F32))
            note("flash_attention_train_fwd", e, dtype, True)
            if dtype == BF16 and rate > 0:
                # the kept probabilities without their 1/(1-rate) scale
                _attn_limit_rejects(f"attention fwd {label} without the keep scale", out_p,
                                    (out_p.float() * (1.0 - rate)).to(BF16))
            del q, k, v, out, lse, out_p, lse_p
    _train_ffn_cases(gen, note)
    return errs


def _sparse_inputs(B, nb, dtype, gen, plan, padded, H=12):
    """q, k, v (B, S, H, 64), a (B, S) mask, an (H, nb-2, 3) plan on the
    card and an output cotangent for the middle rows.  ``plan``: "eval"
    (all zeros) or "train" (HF's training plan at S=4096, else random
    legal blocks)."""
    S = nb * 64
    q, k, v = (torch.randn(B, S, H, 64, generator=gen).to(DEV, dtype) for _ in range(3))
    mask = torch.ones(B, S)
    if padded:
        lengths = torch.randint(S // 2, S, (B,), generator=gen)
        mask = (torch.arange(S)[None, :] < lengths[:, None]).float()
    if plan == "eval":
        rand = torch.zeros(H, nb - 2, 3, dtype=torch.int32)
    elif S == 4096:
        rand = torch.as_tensor(build_rand_attn(S, 64, 3, H, 1, S, training=True)[0])
    else:
        rand = torch.randint(1, nb - 1, (H, nb - 2, 3), generator=gen, dtype=torch.int32)
    do = torch.randn(B, (nb - 2) * 64, H, 64, generator=gen).to(DEV, dtype)
    return q, k, v, mask.to(DEV), rand.to(DEV), do


def phase_sparse_kernels() -> dict:
    """The BigBird kernel pair vs its plain versions on the card, bf16 and
    fp32: the smallest block-sparse S (nb=5), a padded mask (nb=8) and the
    trunk's S=4096, with the eval and the training plan, at B=2 (forward
    and backward) and the serving batch B=8 (forward); bf16 contexts and
    gradients also under the elementwise limits, which must reject three
    faults at S=4096 (``_sparse_limits_reject``).  Returns, per kernel,
    the worst bf16 error at S=4096."""
    gen = torch.Generator().manual_seed(6)
    errs = {}
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for B, nb, padded in ((2, 5, False), (2, 8, True), (2, 64, False), (8, 64, True)):
            for plan in ("eval", "train"):
                q, k, v, mask, rand, do = _sparse_inputs(B, nb, dtype, gen, plan, padded)
                label = f"{tag} B={B} S={nb * 64} {plan} plan{' mask' if padded else ''}"
                out, lse = bigbird_mid_fwd(q, k, v, mask, rand, 64)
                out_p, lse_p = bigbird_mid_fwd_plain(q, k, v, mask, rand, 64)
                e = max(_compare_attn(f"sparse fwd {label}", out, out_p, dtype),
                        _compare(f"sparse lse {label}", lse, lse_p, dtype))
                if dtype == BF16 and nb == 64:
                    errs["bigbird_mid_fwd"] = max(errs.get("bigbird_mid_fwd", 0.0), e)
                if B == 2:
                    got = bigbird_mid_bwd(q, k, v, mask, rand, 64, out_p, lse_p, do)
                    want = bigbird_mid_bwd_plain(q, k, v, mask, rand, 64, out_p, lse_p, do)
                    e = max(_compare_grad(f"sparse {n} {label}", g, w, dtype)
                            for n, g, w in zip(("dq", "dk", "dv"), got, want))
                    if dtype == BF16 and nb == 64:
                        errs["bigbird_mid_bwd"] = max(errs.get("bigbird_mid_bwd", 0.0), e)
                    if dtype == BF16 and nb == 64 and plan == "train":
                        _sparse_limits_reject(label, q, k, v, mask, rand, out_p, lse_p, do,
                                              want[1])
                    del got, want
                del q, k, v, out, lse, out_p, lse_p
    return errs


def _sparse_fwd_with(q, k, v, rand, pen_of):
    """The plain forward's context with the slot penalties (B, H, n, 1, W)
    replaced by ``pen_of(pen, gathered mask)``: a known fault applied to
    the plain version."""
    B, S, H, D = q.shape
    qm, kc, vc, pen, idx = _mid_operands(q, k, v, torch.ones(B, S, device=q.device), rand, 64)
    logits = _mid_logits(qm, kc, pen_of(pen, idx), q.dtype)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhjqk,bhjkd->bhjqd", w.float(), vc.float()).to(q.dtype)
    return ctx.permute(0, 2, 3, 1, 4).reshape(B, -1, H, D)


def _sparse_limits_reject(label, q, k, v, mask, rand, out, lse, do, dk) -> None:
    """At S=4096 (bf16, the training plan, no padding), the limits the
    pair is held to must reject: a context without the first random slot,
    a context where the duplicate window slot (block 0 at query block 1,
    block nb-1 at query block nb-2) keeps its keys, and dK without the g0
    slot's adds."""
    check(bool((mask == 1).all()), "the fault checks take an unpadded mask")
    want = bigbird_mid_fwd_plain(q, k, v, mask, rand, 64)[0]

    def no_random_slot(pen, idx):
        pen = pen.clone()
        pen[..., 5 * 64:6 * 64] = -math.inf
        return pen

    def no_dup_penalty(pen, idx):
        return torch.zeros_like(pen)   # an unpadded mask: only the duplicate slots had one

    _attn_limit_rejects(f"sparse fwd {label} without one random slot", want,
                        _sparse_fwd_with(q, k, v, rand, no_random_slot))
    _attn_limit_rejects(f"sparse fwd {label} without the duplicate slot's penalty", want,
                        _sparse_fwd_with(q, k, v, rand, no_dup_penalty))
    # dK less the g0 slot's adds: sum over the middle query blocks of its
    # dS^T q, taken from block 0's rows
    B, S, H, D = q.shape
    qm, kc, _, pen, _ = _mid_operands(q, k, v, mask, rand, 64)
    f = torch.float32
    p = torch.exp(_mid_logits(qm, kc, pen, q.dtype) - lse.reshape(B, H, -1, 64, 1))
    do_b, o_b = (_blocked(t, 64).float() for t in (do, out))
    vg = _blocked(v, 64)[:, :, 0].float()   # block 0's values (the g0 slot)
    dp = torch.einsum("bhjqd,bhkd->bhjqk", do_b, vg)
    row = (do_b * o_b).sum(dim=-1, keepdim=True)
    ds = p[..., :64] * (dp - row) / math.sqrt(D)
    dk_g0 = torch.einsum("bhjqk,bhjqd->bhkd", ds, qm.to(f))   # (B, H, 64, D)
    wrong = dk.float().clone()
    wrong[:, :64] -= dk_g0.permute(0, 2, 1, 3)
    _grad_limit_rejects(f"sparse dk {label} without the g0 slot's adds", dk, wrong.to(dk.dtype))


def _features(cfg: STonKGsConfig, n: int, seed: int = 0) -> dict:
    """Synthetic rows whose true text lengths are drawn from 10 to 256."""
    rng = np.random.default_rng(seed)
    tl, el = cfg.text_len, cfg.entity_len
    lengths = rng.integers(10, tl + 1, n)
    keep = np.arange(tl)[None, :] < lengths[:, None]
    text = np.where(keep, rng.integers(4, cfg.bert.vocab_size, (n, tl)), 0)
    ent = rng.integers(0, cfg.kg_vocab_size, (n, el))
    return {
        "input_ids": np.concatenate([text, ent], 1).astype(np.int64),
        "attention_mask": np.concatenate(
            [keep.astype(np.int64), np.ones((n, el), np.int64)], 1),
        "token_type_ids": np.concatenate(
            [np.zeros((n, tl), np.int64), np.ones((n, el), np.int64)], 1),
    }


SERVING_KERNELS = {"ffn_ln_block": fused_ffn_ln_block,
                   "flash_attention_infer": flash_attention_infer}
TRAINING_KERNELS = {"flash_attention_train_fwd": flash_attention_train_fwd,
                    "flash_attention_train_bwd": flash_attention_train_bwd,
                    "ffn_train_fwd": fused_ffn_fwd,
                    "ffn_train_bwd": fused_ffn_bwd}


def _reset_counts(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def _counts(kernels: dict) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_serving(cfg: STonKGsConfig):
    """Serving through STonKGsEngine; returns what phase 5 times and the
    main path's launch counts."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    kg_vectors = torch.randn(cfg.kg_vocab_size, cfg.bert.hidden_size,
                             generator=gen).numpy()
    params_bf16 = params_to(params, DEV, BF16)
    # the KG table's special rows come from the backbone on the card
    params["kg_backbone"] = stonkgs.build_kg_table(
        params_bf16["lm_backbone"], cfg.bert, kg_vectors, compute_dtype=BF16).cpu()
    params_bf16["kg_backbone"] = params["kg_backbone"].to(DEV, BF16)
    check(bool(torch.isfinite(params["kg_backbone"]).all()), "KG table not finite")
    log(f"# serving setup (init + KG table): {time.perf_counter() - t0:.1f} s")

    feats = _features(cfg, ROWS)
    engine = STonKGsEngine(cfg=cfg, params=params_bf16, batch_size=BATCH, device=DEV)
    bucketed = STonKGsEngine(cfg=cfg, params=params_bf16, batch_size=BATCH,
                             length_buckets=BUCKETS, device=DEV)

    # the main path: parity-mode embed, counts from 0 just before it
    _reset_counts(SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(SERVING_KERNELS)
    n_batches = math.ceil(ROWS / BATCH)
    per_batch = cfg.bert.num_hidden_layers * 2 - 1   # backbone 12 + trunk 11
    log(f"# launches parity embed ({n_batches} batches): {counts}")
    check(out.shape == (ROWS, cfg.bert.hidden_size), f"embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "embed output not finite")
    for name, c in counts.items():
        check(c == per_batch * n_batches,
              f"{name}: {c} launches, expected {per_batch} x {n_batches}")

    _reset_counts(SERVING_KERNELS)
    out_b = bucketed.embed(feats)
    counts_b = _counts(SERVING_KERNELS)
    log(f"# launches bucketed embed: {counts_b}")
    check(out_b.shape == out.shape and bool(np.isfinite(out_b).all()),
          "bucketed embed output wrong")
    check(all(c > 0 for c in counts_b.values()), "bucketed embed skipped a kernel")

    # numerics: card fp32 vs CPU fp32, card bf16 vs CPU fp32, on 4 rows
    few = {k: v[:4] for k, v in feats.items()}
    card32 = STonKGsEngine(cfg=cfg, params=params, compute_dtype="float32",
                           batch_size=4, device=DEV).embed(few)
    cpu32 = STonKGsEngine(cfg=cfg, params=params, compute_dtype="float32",
                          batch_size=4, device="cpu").embed(few)
    err32 = float(np.abs(card32 - cpu32).max())
    cos = _cosine(out[:4], cpu32)
    log(f"# card fp32 vs CPU fp32 (4 rows): max_abs_err {err32!r} (limit 1e-3)")
    log(f"# card bf16 vs CPU fp32 (4 rows): cosine {cos.tolist()!r} (limit 0.99)")
    check(err32 <= 1e-3, "card fp32 disagrees with the CPU")
    check(bool((cos >= 0.99).all()), "card bf16 too far from the CPU fp32")
    cos_b = _cosine(out_b, out)
    log(f"# bucketed vs parity (bf16, {ROWS} rows): min cosine {float(cos_b.min())!r}")
    return engine, bucketed, feats, counts, params


_time_ms = functools.partial(time_ms, iters=10)


def _bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def _time_ffn(label: str, M: int, gen, H=768, I=3072, act="gelu") -> dict:
    """Kernel vs plain at the main path's shape, then both timed, and the
    two cuBLAS bf16 products the block contains (x @ W1, h @ W2) alone, a
    yardstick only: no one PyTorch call computes the block."""
    args = _ffn_inputs(M, BF16, gen, H, I)
    flops = 4.0 * M * H * I
    nbytes = (3 * M * H + 2 * H * I) * 2 + (5 * H + I) * 4
    bound, by = _bound_ms(flops, nbytes, BF16)
    err = _compare(f"ffn_ln bf16 {label}", fused_ffn_ln_block(*args, act=act),
                   fused_ffn_ln_block_plain(*args, act=act), BF16)
    x, w1, w2 = args[0], args[4], args[6]
    h = x @ w1
    t = dict(max_abs_err=err,
             ms=_time_ms(lambda: fused_ffn_ln_block(*args, act=act)),
             plain_ms=_time_ms(lambda: fused_ffn_ln_block_plain(*args, act=act), iters=3),
             bound_ms=bound, bound_by=by, library_ms=None,
             cublas_gemms_ms=_time_ms(lambda: x @ w1) + _time_ms(lambda: h @ w2))
    log(f"# rate ffn_ln_block {label}: {flops / (t['ms'] * 1e-3) / 1e12!r} TFLOP/s at "
        f"{flops:.4g} flops; {t['ms'] / t['cublas_gemms_ms']!r} x the two cuBLAS products")
    return t


def _time_attention(label: str, B: int, S: int, masked: bool, gen, H=12) -> dict:
    """Kernel vs plain at the main path's shape, then both and SDPA timed."""
    q, k, v, bias, keep = _attn_inputs(B, S, BF16, gen, masked, H)
    H, D = q.shape[2], q.shape[3]
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * B * S * H * D * 2 + (B * S * 4 if masked else 0)
    bound, by = _bound_ms(flops, nbytes, BF16)
    err = _compare_attn(f"attention bf16 {label}", flash_attention_infer(q, k, v, bias),
                        flash_attention_infer_plain(q, k, v, bias), BF16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # views, no copy
    mask = None if keep is None else keep[:, None, None, :]
    t = dict(max_abs_err=err,
             ms=_time_ms(lambda: flash_attention_infer(q, k, v, bias)),
             plain_ms=_time_ms(lambda: flash_attention_infer_plain(q, k, v, bias), iters=3),
             bound_ms=bound, bound_by=by,
             library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask)))
    _log_attention_rate(f"flash_attention_infer {label}", flops, t)
    return t


def _log_attention_rate(label: str, flops: float, t: dict) -> None:
    """The kernel's TFLOP/s at the counted products and its time as a
    multiple of SDPA's."""
    log(f"# rate {label}: {flops / (t['ms'] * 1e-3) / 1e12!r} TFLOP/s at "
        f"{flops:.4g} flops; {t['ms'] / t['library_ms']!r} x SDPA")


def phase_timing(cfg: STonKGsConfig, engine, bucketed, feats) -> dict:
    """Embed throughput, then each kernel at the main path's shapes (held
    against its plain version there, then timed); returns, per kernel, the
    trunk shape's numbers with the worse error of the two shapes."""
    for label, eng in (("parity", engine), ("bucketed", bucketed)):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.embed(feats)
            times.append(time.perf_counter() - t0)
        check(bool(np.isfinite(out).all()), f"{label} embed not finite")
        n = len(out)
        log(f"# embed {label}: {n} rows, B={BATCH}, seconds {times!r}; "
            f"best {n / min(times)!r} pairs/s, median "
            f"{n / statistics.median(times)!r} pairs/s")
    gen = torch.Generator().manual_seed(2)
    tl, sl = cfg.text_len, cfg.seq_len
    shapes = {
        "ffn_ln_block": [(f"trunk M={BATCH * sl}", _time_ffn, (BATCH * sl,)),
                         (f"backbone M={BATCH * tl}", _time_ffn, (BATCH * tl,))],
        "flash_attention_infer": [
            (f"trunk B={BATCH} S={sl} mask", _time_attention, (BATCH, sl, True)),
            (f"backbone B={BATCH} S={tl} no-bias", _time_attention, (BATCH, tl, False))],
    }
    result = {}
    for name, cases in shapes.items():
        for i, (label, fn, args) in enumerate(cases):
            t = fn(label, *args, gen)
            log(f"# time {name} {label} bf16: {json.dumps(t)}")
            if i == 0:
                result[name] = t   # the trunk shape goes into the kernel line
            else:
                result[name + ":backbone"] = t
                result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                                  t["max_abs_err"])
    # a parity batch's kernel time from these per-call times
    layers = cfg.bert.num_hidden_layers
    kern = (layers * result["ffn_ln_block:backbone"]["ms"]
            + (layers - 1) * result["ffn_ln_block"]["ms"]
            + layers * result["flash_attention_infer:backbone"]["ms"]
            + (layers - 1) * result["flash_attention_infer"]["ms"])
    log(f"# kernel time per parity batch of {BATCH} ({layers} backbone + "
        f"{layers - 1} trunk layers, from the per-call times): {kern!r} ms")
    return result


def _pretraining_features(cfg: STonKGsConfig, n: int, seed: int = 0) -> dict:
    """Synthetic pre-training rows as ``benchmarks/_util.py`` builds them:
    uniform tokens and entities, exactly int(0.15 * len) masked positions
    per half, random NSP labels."""
    rng = np.random.default_rng(seed)
    tl, el = cfg.text_len, cfg.entity_len
    text = rng.integers(0, cfg.bert.vocab_size, (n, tl))
    ent = rng.integers(0, cfg.kg_vocab_size, (n, el))
    mlm = np.full((n, tl), -100, np.int64)
    elm = np.full((n, el), -100, np.int64)
    k_text, k_ent = int(tl * 0.15), int(el * 0.15)
    for i in range(n):
        mlm[i, rng.choice(tl, k_text, replace=False)] = rng.integers(
            0, cfg.bert.vocab_size, k_text)
        elm[i, rng.choice(el, k_ent, replace=False)] = rng.integers(
            0, cfg.kg_vocab_size, k_ent)
    return {
        "input_ids": np.concatenate([text, ent], 1).astype(np.int64),
        "attention_mask": np.ones((n, tl + el), np.int64),
        "token_type_ids": np.concatenate(
            [np.zeros((n, tl), np.int64), np.ones((n, el), np.int64)], 1),
        "masked_lm_labels": mlm,
        "ent_masked_lm_labels": elm,
        "next_sentence_labels": rng.integers(0, 2, (n,)).astype(np.int64),
    }


def phase_training(cfg: STonKGsConfig, params_cpu: dict):
    """``pretrain`` at full width on the card: the main training path,
    counts from 0 just before it.  Returns its launch counts and state."""
    t0 = time.perf_counter()
    params = params_to(params_cpu, DEV)   # fp32 parameters on the card
    frozen_before = tree_map(lambda t: t.clone(), split_frozen(params)[1])
    feats = _pretraining_features(cfg, TRAIN_BATCH * TRAIN_STEPS)
    run_cfg = pretraining.PretrainingConfig(
        max_steps=TRAIN_STEPS, micro_batch_size=TRAIN_BATCH, log_steps=1,
        compute_dtype="bfloat16")
    logged = []
    log(f"# training setup: {time.perf_counter() - t0:.1f} s")
    _reset_counts(TRAINING_KERNELS)
    state = pretraining.pretrain(cfg, params, feats, run_cfg,
                                 log_fn=lambda step, m: logged.append((step, m)))
    torch.cuda.synchronize()
    counts = _counts(TRAINING_KERNELS)
    layers = cfg.bert.num_hidden_layers
    log(f"# launches pretrain ({TRAIN_STEPS} steps, B={TRAIN_BATCH}): {counts}")
    expected = {"flash_attention_train_fwd": 2 * layers, "flash_attention_train_bwd": layers,
                "ffn_train_fwd": 2 * layers, "ffn_train_bwd": layers}
    for name, per_step in expected.items():
        check(counts[name] == per_step * TRAIN_STEPS,
              f"{name}: {counts[name]} launches, expected {per_step} x {TRAIN_STEPS}")
    for step, m in logged:
        log(f"# pretrain step {step}: " + json.dumps(m))
    check([s for s, _ in logged] == list(range(1, TRAIN_STEPS + 1)),
          f"pretrain logged steps {[s for s, _ in logged]}")
    check(all(math.isfinite(m["loss"]) for _, m in logged), "non-finite pretraining loss")
    frozen_after = split_frozen(state.params)[1]
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(frozen_before),
                                                tree_leaves(frozen_after))),
          "a frozen backbone changed")
    before, after = _named_leaves(split_frozen(params)[0]), _named_leaves(state.params)
    unchanged = [k for k in before if torch.equal(before[k], after[k])]
    log(f"# trainable leaves unchanged after {TRAIN_STEPS} steps: {unchanged}")
    check(set(unchanged) <= set(UNUSED_LEAVES), "a trainable leaf did not change")
    return counts, state


# trainable leaves that take no part in the pre-training loss, in both
# packages: the trunk reads backbone embeddings, not its word embeddings,
# and the ELM decoder biases are never applied (the reference's quirk)
UNUSED_LEAVES = ("trunk/embeddings/word_embeddings", "cls/predictions/text_bias",
                 "cls/predictions/entity_bias")


def _named_leaves(tree, prefix: str = "") -> dict:
    """{"a/b/0/c": tensor} for a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, sub in items:
        out.update(_named_leaves(sub, f"{prefix}/{k}" if prefix else str(k)))
    return out


# trunk leaves whose gradient is zero in exact arithmetic: a key bias
# adds the same q . b_k to every score of a query row, which the softmax
# cancels; both sides hold it at the rounding level, where a cosine means
# nothing
ZERO_GRAD_LEAVES = ("attention/key/bias",)


def phase_train_numerics(cfg_full: STonKGsConfig) -> None:
    """Loss and trunk gradients at 2 rows and 2 layers of the full width,
    hidden dropout 0 and attention dropout 0.1 (the attention seeds come
    from the same CPU generator on both sides), against the CPU in fp32:
    the card in fp32 (the SIMT bodies), then the card in bf16 (the Hopper
    kernels), each leaf by its cosine."""
    bcfg = dataclasses.replace(cfg_full.bert, num_hidden_layers=2, hidden_dropout_prob=0.0)
    cfg = cfg_full.replace(bert=bcfg)
    gen = torch.Generator().manual_seed(5)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    params["kg_backbone"] = torch.randn(cfg.kg_table_size, bcfg.hidden_size, generator=gen)
    feats = _pretraining_features(cfg, 2, seed=7)

    def loss_and_grads(device, dtype=F32):
        p = params_to(params, device)
        named = _named_leaves(p["trunk"])
        for t in named.values():
            t.requires_grad_(True)
        loss, _ = stonkgs.pretraining_loss(
            p, cfg, pretraining.to_device(feats, device), deterministic=False,
            rng=pretraining.step_rng(0, 0, device), compute_dtype=dtype)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        for t in named.values():
            t.requires_grad_(False)
        # the trunk's word embeddings take no part (it reads the backbones')
        return float(loss.detach()), {n: g.detach().cpu() for n, g in zip(named, grads)
                                      if g is not None}

    launches = flash_attention_train_fwd.launches
    loss_card, g_card = loss_and_grads(DEV)
    check(flash_attention_train_fwd.launches > launches, "the card run launched no kernel")
    loss_cpu, g_cpu = loss_and_grads("cpu")
    check(g_card.keys() == g_cpu.keys(), "card and CPU differ in their gradient leaves")
    err = max(float((g_card[n] - g_cpu[n]).abs().max()) for n in g_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    log(f"# train card fp32 vs CPU fp32 (2 rows, 2 layers, attention dropout "
        f"{ATTN_RATE}): loss {loss_card!r} vs {loss_cpu!r}; trunk grads max_abs_err "
        f"{err!r} of max |grad| {scale!r} (limits: loss 1e-4 relative, grads 1e-3 of "
        f"max |grad|)")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu), "card loss disagrees with the CPU")
    check(err <= 1e-3 * scale, "card gradients disagree with the CPU")

    # bf16 compute on the card: every FFN of the 2 trunk and 2 backbone
    # layers through the Hopper pair
    before = (fused_ffn_fwd.launches, fused_ffn_bwd.launches)
    loss_bf16, g_bf16 = loss_and_grads(DEV, BF16)
    check(fused_ffn_fwd.launches - before[0] == 4 and fused_ffn_bwd.launches - before[1] == 2,
          f"bf16 numerics launched the FFN pair {fused_ffn_fwd.launches - before[0]} / "
          f"{fused_ffn_bwd.launches - before[1]} times, expected 4 / 2")
    check(g_bf16.keys() == g_cpu.keys(), "card bf16 and CPU differ in their gradient leaves")
    norm_max = max(float(g.norm()) for g in g_cpu.values())
    cosines = {}
    for n, want in g_cpu.items():
        got = g_bf16[n].double().flatten()
        w = want.double().flatten()
        if n.endswith(ZERO_GRAD_LEAVES):
            check(float(w.norm()) <= 1e-6 * norm_max and float(got.norm()) <= 1e-4 * norm_max,
                  f"{n}: a gradient that should cancel reads {float(w.norm())!r} (CPU), "
                  f"{float(got.norm())!r} (card bf16) of the largest leaf norm {norm_max!r}")
            continue
        cosines[n] = float(got @ w / (got.norm() * w.norm()))
    worst = min(cosines, key=cosines.get)
    rel = abs(loss_bf16 - loss_cpu) / abs(loss_cpu)
    log(f"# train card bf16 vs CPU fp32 (same rows and seeds): loss {loss_bf16!r} vs "
        f"{loss_cpu!r} ({rel!r} relative; limit 1e-2); {len(cosines)} trunk gradient leaves, "
        f"lowest cosine {cosines[worst]!r} ({worst}; limit 0.99); mean "
        f"{statistics.fmean(cosines.values())!r}; {ZERO_GRAD_LEAVES} at the rounding level "
        f"on both sides")
    check(rel <= 1e-2, "card bf16 loss disagrees with the CPU")
    check(cosines[worst] >= 0.99, f"card bf16 gradient {worst} disagrees with the CPU")


def _time_train_attention(label, B, S, masked, gen, backward, H=12) -> dict:
    """A training attention kernel vs plain at the step's shape, then both
    and the library call (SDPA without dropout, which cannot draw the
    hash mask) timed."""
    q, k, v, bias, keep, seed, do = _train_attn_inputs(B, S, BF16, gen, masked, H)
    H, D = q.shape[2], q.shape[3]
    io = B * S * H * D * 2   # one (B, S, H, D) bf16 tensor
    stats = B * H * S * 4    # lse (and, backward, delta is scratch: not counted)
    kb = B * S * 4 if masked else 0
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if keep is None else keep[:, None, None, :]
    flops = (10.0 if backward else 4.0) * B * H * S * S * D
    if not backward:
        bound, by = _bound_ms(flops, 4 * io + stats + kb, BF16)
        fn = lambda: flash_attention_train_fwd(q, k, v, bias, seed, ATTN_RATE)  # noqa: E731
        plain = lambda: flash_attention_train_fwd_plain(q, k, v, bias, seed, ATTN_RATE)  # noqa: E731
        err = _compare_attn(f"attention fwd bf16 {label}", fn()[0], plain()[0], BF16)
        lib = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    else:
        out, lse = flash_attention_train_fwd(q, k, v, bias, seed, ATTN_RATE)
        # the path's bias takes no gradient: no db
        bound, by = _bound_ms(flops, 8 * io + stats + kb, BF16)
        fn = lambda: flash_attention_train_bwd(  # noqa: E731
            q, k, v, bias, out, lse, do, seed, ATTN_RATE, need_db=False)
        plain = lambda: flash_attention_train_bwd_plain(  # noqa: E731
            q, k, v, bias, out, lse, do, seed, ATTN_RATE, need_db=False)
        err = max(_compare_grad(f"attention {n} bf16 {label}", g, w, BF16)
                  for n, g, w in zip(("dq", "dk", "dv"), fn()[:3], plain()[:3]))
        lib = _time_sdpa_backward(label, qt, kt, vt, mask, do.transpose(1, 2))
    t = dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
             bound_ms=bound, bound_by=by, library_ms=lib)
    _log_attention_rate(f"flash_attention_train_{'bwd' if backward else 'fwd'} {label}", flops,
                        t)
    return t


def _time_sdpa_backward(label, q, k, v, mask, dout) -> float:
    """SDPA's backward alone: one forward with inputs that require grad,
    then ``torch.autograd.grad`` over that saved graph, timed; logs the
    backend that ran and its kernels' device time (from three traced
    backwards: the timed call also carries autograd's host work)."""
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

    def backward():
        return torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True)
    backward()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            backward()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    names = sorted(e.key for e in events)
    device_ms = sum(e.self_device_time_total for e in events) / 3 / 1e3
    low = " ".join(names).lower()
    backend = ("cudnn" if "cudnn" in low else "flash" if "flash" in low
               else "efficient" if ("fmha" in low or "efficient" in low) else "math")
    ms = _time_ms(backward)
    log(f"# SDPA backward {label}: {ms!r} ms a call alone over a saved forward, "
        f"{device_ms!r} ms of it on the device, backend {backend}; kernels {names}")
    return ms


def _time_train_ffn(label, M, gen, backward, H=768, I=3072, act="gelu") -> dict:
    """A training FFN kernel vs plain at the path's shape, then both timed,
    and the cuBLAS bf16 products the kernel contains timed alone (x W1 + h
    W2 forward; x W1 + g W2^T + dh W1^T backward), a yardstick only: no
    one PyTorch call computes the fused function."""
    x, w1, b1, w2, b2, g = _train_ffn_inputs(M, BF16, gen, H, I)
    w1b, w2b = w1.to(BF16), w2.to(BF16)
    if not backward:
        flops = 4.0 * M * H * I
        bound, by = _bound_ms(flops, 2 * M * H * 2 + 2 * H * I * 2 + (H + I) * 4, BF16)
        fn = lambda: fused_ffn_fwd(x, w1, b1, w2, b2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_plain(x, w1, b1, w2, b2, act=act)  # noqa: E731
        err = _compare(f"ffn fwd bf16 {label}", fn(), plain(), BF16)
        h = x @ w1b
        gemms = [lambda: x @ w1b, lambda: h @ w2b]
    else:
        # x, g, dx; dh and a; W1 and W2 in bf16; b1
        flops = 6.0 * M * H * I
        nbytes = 3 * M * H * 2 + 2 * M * I * 2 + 2 * H * I * 2 + I * 4
        bound, by = _bound_ms(flops, nbytes, BF16)
        fn = lambda: fused_ffn_bwd(x, g, w1, b1, w2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)  # noqa: E731
        got, want = fn(), plain()
        err = max(_compare_rel(f"ffn dx bf16 {label}", got[0], want[0], BF16),
                  _compare_rel(f"ffn dh bf16 {label}", got[1], want[1], BF16),
                  _compare(f"ffn a bf16 {label}", got[2], want[2], BF16))
        dh = got[1]
        gemms = [lambda: x @ w1b, lambda: g @ w2b.T, lambda: dh @ w1b.T]
    t = dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
             bound_ms=bound, bound_by=by, library_ms=None,
             cublas_gemms_ms=sum(_time_ms(f) for f in gemms))
    log(f"# rate ffn_train_{'bwd' if backward else 'fwd'} {label}: "
        f"{flops / (t['ms'] * 1e-3) / 1e12!r} TFLOP/s at {flops:.4g} flops; "
        f"{t['ms'] / t['cublas_gemms_ms']!r} x the {len(gemms)} cuBLAS products")
    return t


def phase_train_timing(cfg: STonKGsConfig, state) -> dict:
    """Step time at B=32 (sync through the loss), then each training kernel
    at the step's shapes; returns, per kernel, the trunk shape's numbers."""
    tx = AdamW(total_steps=1000)
    step = pretraining.make_train_step(cfg, tx, compute_dtype=BF16)
    feats = _pretraining_features(cfg, TRAIN_BATCH, seed=11)
    batch = pretraining.to_device(feats, DEV)
    times = []
    for i in range(2 + 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if i >= 2:
            times.append(time.perf_counter() - t0)
        check(math.isfinite(loss), "non-finite loss in the timed steps")
    med = statistics.median(times)
    log(f"# train step B={TRAIN_BATCH} bf16: seconds {times!r}; median "
        f"{med * 1e3!r} ms, {TRAIN_BATCH / med!r} examples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    gen = torch.Generator().manual_seed(4)
    tl, sl, B = cfg.text_len, cfg.seq_len, TRAIN_BATCH
    cases = {
        "flash_attention_train_fwd": [
            (f"trunk B={B} S={sl} mask", _time_train_attention, (B, sl, True, False)),
            (f"backbone B={B} S={tl} no-bias", _time_train_attention, (B, tl, False, False))],
        "flash_attention_train_bwd": [
            (f"trunk B={B} S={sl} mask", _time_train_attention, (B, sl, True, True))],
        "ffn_train_fwd": [(f"trunk M={B * sl}", _time_train_ffn, (B * sl, False)),
                          (f"backbone M={B * tl}", _time_train_ffn, (B * tl, False))],
        "ffn_train_bwd": [(f"trunk M={B * sl}", _time_train_ffn, (B * sl, True))],
    }
    result = {}
    for name, shapes in cases.items():
        for i, (label, fn, args) in enumerate(shapes):
            t = fn(label, *args[:-1], gen, args[-1])
            log(f"# time {name} {label} bf16: {json.dumps(t)}")
            if i == 0:
                result[name] = t
            else:
                result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                                  t["max_abs_err"])
                result[name + ":backbone"] = t
    layers = cfg.bert.num_hidden_layers
    kern = (layers * (result["flash_attention_train_fwd"]["ms"]
                      + result["flash_attention_train_fwd:backbone"]["ms"]
                      + result["flash_attention_train_bwd"]["ms"]
                      + result["ffn_train_fwd"]["ms"] + result["ffn_train_fwd:backbone"]["ms"]
                      + result["ffn_train_bwd"]["ms"]))
    log(f"# kernel time per training step ({layers} backbone + {layers} trunk layers, "
        f"from the per-call times): {kern!r} ms of {med * 1e3!r} ms")
    return result


# ---------------------------------------------------------------------------
# ProtSTonKGs: serving and pre-training
# ---------------------------------------------------------------------------

PROT_BATCH = 8
PROT_ROWS = 32
PROT_TRAIN_BATCH = 2
PROT_TRAIN_STEPS = 4
PROT_SERVING_KERNELS = {"bigbird_mid_fwd": bigbird_mid_fwd, **SERVING_KERNELS}
PROT_TRAINING_KERNELS = {"bigbird_mid_fwd": bigbird_mid_fwd,
                         "bigbird_mid_bwd": bigbird_mid_bwd, **TRAINING_KERNELS}
# trainable leaves outside the ProtSTonKGs loss: the trunk reads backbone
# embeddings, not its word embeddings; there is no NSP head on the pooler;
# the decoder biases are never applied
PROT_UNUSED_LEAVES = ("trunk/embeddings/word_embeddings", "trunk/pooler/kernel",
                      "trunk/pooler/bias", "cls/predictions/text_bias",
                      "cls/predictions/entity_bias", "cls/predictions/prot_bias")


def _prot_cfg(kg_vocab: int = 20_000, layers: Optional[int] = None,
              hidden_dropout: Optional[float] = None) -> ProtSTonKGsConfig:
    """The published widths (BigBird trunk 12 x 768, BioBERT 12 x 768,
    ProtBERT 30 x 1024, 4096 = 768 | 256 | 3072), KG vocabulary 20,000 as
    ``benchmarks/bench_protstonkgs.py:31``; ``layers`` cuts every stack's
    depth, ``hidden_dropout`` sets every hidden dropout."""
    trunk, lm, prot = BigBirdConfig(), BertConfig(), ProtSTonKGsConfig().prot
    cut = {} if layers is None else {"num_hidden_layers": layers}
    if hidden_dropout is not None:
        cut["hidden_dropout_prob"] = hidden_dropout
    return ProtSTonKGsConfig(trunk=dataclasses.replace(trunk, **cut),
                             lm=dataclasses.replace(lm, **cut),
                             prot=dataclasses.replace(prot, **cut), kg_vocab_size=kg_vocab)


def _prot_params(cfg: ProtSTonKGsConfig, seed: int, dtype=F32):
    """Seeded random parameters (fp32 on the CPU) with the KG table built
    on the card in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    params = protstonkgs.init_protstonkgs_params(gen, cfg)
    vectors = torch.randn(cfg.kg_vocab_size, cfg.trunk.hidden_size, generator=gen).numpy()
    lm = params_to(params["lm_backbone"], DEV, dtype)
    params["kg_backbone"] = protstonkgs.build_kg_table(lm, cfg, vectors,
                                                       compute_dtype=dtype).cpu()
    check(bool(torch.isfinite(params["kg_backbone"]).all()), "KG table not finite")
    return params


def _prot_features(cfg: ProtSTonKGsConfig, n: int, seed: int = 0, labels: bool = False):
    """Rows of uniform random ids with a full mask; with ``labels``, k =
    max(int(0.15 * len), 1) masked positions per segment, as
    ``benchmarks/bench_protstonkgs.py:115-134`` builds them."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, cfg.lm.vocab_size, (n, cfg.text_len)),
                          rng.integers(0, cfg.kg_table_size, (n, cfg.entity_len)),
                          rng.integers(0, cfg.prot_vocab_size, (n, cfg.prot_len))], 1)
    out = {"input_ids": ids.astype(np.int64),
           "attention_mask": np.ones((n, cfg.seq_len), np.int64)}
    if labels:
        for name, length, vocab in (("masked_lm_labels", cfg.text_len, cfg.lm_vocab_size),
                                    ("ent_masked_lm_labels", cfg.entity_len,
                                     cfg.kg_vocab_size),
                                    ("prot_masked_lm_labels", cfg.prot_len,
                                     cfg.prot_vocab_size)):
            k = max(int(length * 0.15), 1)
            lab = np.full((n, length), -100, np.int64)
            for i in range(n):
                lab[i, rng.choice(length, k, replace=False)] = rng.integers(0, vocab, k)
            out[name] = lab
    return out


def _train_plan(cfg: ProtSTonKGsConfig) -> np.ndarray:
    t = cfg.trunk
    return build_rand_attn(cfg.seq_len, t.block_size, t.num_random_blocks,
                           t.num_attention_heads, t.num_hidden_layers,
                           t.max_position_embeddings, training=True)


def phase_prot_serving(cfg: ProtSTonKGsConfig):
    """``ProtSTonKGsEngine.embed`` at full width (B=8, 32 rows): the main
    serving path, counts from 0 just before it; then card fp32 vs CPU fp32
    and card bf16 vs CPU fp32 on 2 rows at 2 layers per stack.  Returns
    the engine, the rows, the launch counts and the fp32 parameters."""
    t0 = time.perf_counter()
    params = _prot_params(cfg, seed=10, dtype=BF16)
    engine = ProtSTonKGsEngine(cfg=cfg, params=params_to(params, DEV, BF16),
                               batch_size=PROT_BATCH, device=DEV)
    feats = _prot_features(cfg, PROT_ROWS)
    log(f"# ProtSTonKGs serving setup (init + KG table): {time.perf_counter() - t0:.1f} s")
    _reset_counts(PROT_SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(PROT_SERVING_KERNELS)
    n_batches = math.ceil(PROT_ROWS / PROT_BATCH)
    t, lm, prot = cfg.trunk, cfg.lm, cfg.prot
    per_batch = {"bigbird_mid_fwd": t.num_hidden_layers - 1,
                 "ffn_ln_block": lm.num_hidden_layers + prot.num_hidden_layers
                 + t.num_hidden_layers - 1,
                 "flash_attention_infer": lm.num_hidden_layers + prot.num_hidden_layers}
    log(f"# launches ProtSTonKGs embed ({n_batches} batches of {PROT_BATCH}): {counts}")
    check(out.shape == (PROT_ROWS, t.hidden_size), f"ProtSTonKGs embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "ProtSTonKGs embed output not finite")
    for name, c in per_batch.items():
        check(counts[name] == c * n_batches,
              f"{name}: {counts[name]} launches, expected {c} x {n_batches}")

    # numerics at 2 layers per stack, full widths and layout
    small = _prot_cfg(cfg.kg_vocab_size, layers=2)
    p32 = _prot_params(small, seed=11)
    few = _prot_features(small, 2, seed=1)
    card32 = ProtSTonKGsEngine(cfg=small, params=p32, compute_dtype="float32",
                               batch_size=2, device=DEV).embed(few)
    card16 = ProtSTonKGsEngine(cfg=small, params=params_to(p32, DEV, BF16),
                               batch_size=2, device=DEV).embed(few)
    cpu32 = ProtSTonKGsEngine(cfg=small, params=p32, compute_dtype="float32",
                              batch_size=2, device="cpu").embed(few)
    err32 = float(np.abs(card32 - cpu32).max())
    cos = _cosine(card16, cpu32)
    log(f"# ProtSTonKGs card fp32 vs CPU fp32 (2 rows, 2 layers a stack): max_abs_err "
        f"{err32!r} (limit 1e-3)")
    log(f"# ProtSTonKGs card bf16 vs CPU fp32 (2 rows, 2 layers a stack): cosine "
        f"{cos.tolist()!r} (limit 0.99)")
    check(err32 <= 1e-3, "ProtSTonKGs card fp32 disagrees with the CPU")
    check(bool((cos >= 0.99).all()), "ProtSTonKGs card bf16 too far from the CPU fp32")
    return engine, feats, counts, params


def phase_prot_training(cfg: ProtSTonKGsConfig, params_cpu: dict):
    """``pretrain(..., loss_fn=protstonkgs.pretraining_loss)`` at full width
    (B=2, fp32 parameters, bf16 compute, the training plan): the main
    training path, counts from 0 just before it.  Returns its launch
    counts, its state and the loss function."""
    t0 = time.perf_counter()
    params = params_to(params_cpu, DEV)
    frozen_before = tree_map(lambda t: t.clone(), split_frozen(params)[1])
    feats = _prot_features(cfg, PROT_TRAIN_BATCH * PROT_TRAIN_STEPS, seed=2, labels=True)
    loss_fn = functools.partial(protstonkgs.pretraining_loss, rand_attn=_train_plan(cfg))
    run_cfg = pretraining.PretrainingConfig(
        max_steps=PROT_TRAIN_STEPS, micro_batch_size=PROT_TRAIN_BATCH, log_steps=1,
        compute_dtype="bfloat16")
    logged = []
    log(f"# ProtSTonKGs training setup: {time.perf_counter() - t0:.1f} s")
    _reset_counts(PROT_TRAINING_KERNELS)
    state = pretraining.pretrain(cfg, params, feats, run_cfg, loss_fn=loss_fn,
                                 log_fn=lambda step, m: logged.append((step, m)))
    torch.cuda.synchronize()
    counts = _counts(PROT_TRAINING_KERNELS)
    t, lm, prot = cfg.trunk, cfg.lm, cfg.prot
    log(f"# launches ProtSTonKGs pretrain ({PROT_TRAIN_STEPS} steps, B={PROT_TRAIN_BATCH}): "
        f"{counts}")
    expected = {"bigbird_mid_fwd": t.num_hidden_layers, "bigbird_mid_bwd": t.num_hidden_layers,
                "ffn_train_fwd": lm.num_hidden_layers + prot.num_hidden_layers
                + t.num_hidden_layers,
                "ffn_train_bwd": t.num_hidden_layers,
                "flash_attention_train_fwd": lm.num_hidden_layers + prot.num_hidden_layers}
    for name, per_step in expected.items():
        check(counts[name] == per_step * PROT_TRAIN_STEPS,
              f"{name}: {counts[name]} launches, expected {per_step} x {PROT_TRAIN_STEPS}")
    for step, m in logged:
        log(f"# ProtSTonKGs pretrain step {step}: " + json.dumps(m))
    check([s for s, _ in logged] == list(range(1, PROT_TRAIN_STEPS + 1)),
          f"ProtSTonKGs pretrain logged steps {[s for s, _ in logged]}")
    check(all(math.isfinite(m["loss"]) for _, m in logged),
          "non-finite ProtSTonKGs pretraining loss")
    frozen_after = split_frozen(state.params)[1]
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(frozen_before),
                                                tree_leaves(frozen_after))),
          "a frozen ProtSTonKGs backbone changed")
    before, after = _named_leaves(split_frozen(params)[0]), _named_leaves(state.params)
    unchanged = [k for k in before if torch.equal(before[k], after[k])]
    log(f"# ProtSTonKGs trainable leaves unchanged after {PROT_TRAIN_STEPS} steps: "
        f"{unchanged}")
    check(set(unchanged) <= set(PROT_UNUSED_LEAVES), "a trainable leaf did not change")
    check(not any(k.startswith("prot_projection") for k in unchanged),
          "prot_projection did not train")
    return counts, state, loss_fn


def phase_prot_train_numerics(cfg_full: ProtSTonKGsConfig) -> None:
    """Loss and trunk gradients, card fp32 vs CPU fp32, at 2 rows and 2
    layers a stack of the full widths, hidden dropout 0 and the backbones'
    attention dropout 0.1 (seeds from the same CPU generator)."""
    cfg = _prot_cfg(cfg_full.kg_vocab_size, layers=2, hidden_dropout=0.0)
    params = _prot_params(cfg, seed=12)
    feats = _prot_features(cfg, 2, seed=3, labels=True)
    plan = _train_plan(cfg)

    def loss_and_grads(device):
        p = params_to(params, device)
        leaves = tree_leaves(p["trunk"]) + tree_leaves(p["prot_projection"])
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = protstonkgs.pretraining_loss(
            p, cfg, pretraining.to_device(feats, device), deterministic=False,
            rng=pretraining.step_rng(0, 0, device), compute_dtype=F32, rand_attn=plan)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [g.detach().cpu() for g in grads if g is not None]

    launches = bigbird_mid_bwd.launches
    loss_card, g_card = loss_and_grads(DEV)
    check(bigbird_mid_bwd.launches > launches, "the card run launched no sparse backward")
    loss_cpu, g_cpu = loss_and_grads("cpu")
    err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
    scale = max(float(b.abs().max()) for b in g_cpu)
    log(f"# ProtSTonKGs train card fp32 vs CPU fp32 (2 rows, 2 layers a stack, attention "
        f"dropout {ATTN_RATE}): loss {loss_card!r} vs {loss_cpu!r}; trunk and projection "
        f"grads max_abs_err {err!r} of max |grad| {scale!r} (limits: loss 1e-4 relative, "
        f"grads 1e-3 of max |grad|)")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu),
          "ProtSTonKGs card loss disagrees with the CPU")
    check(err <= 1e-3 * scale, "ProtSTonKGs card gradients disagree with the CPU")


def _time_sparse(label: str, B: int, gen, backward: bool, plan: str) -> dict:
    """A BigBird kernel vs plain at the path's shape (S=4096, H=12), then
    both timed, beside the bound and the design's floor (the forward: two
    exps a score on the SFU or its three products; the backward: its seven
    products, dS as two bf16 terms, or its one exp a score) and the library
    call: SDPA over operands gathered beforehand (``benchmarks/
    bigbird_sdpa.py``), its backward alone over a saved forward."""
    nb, H, D, r = 64, 12, 64, 3
    q, k, v, mask, rand, do = _sparse_inputs(B, nb, BF16, gen, plan, False, H)
    n_mid, W = nb - 2, (5 + r) * 64
    tensor = B * nb * 64 * H * D * 2           # one (B, S, H, D) bf16 tensor
    mid = B * n_mid * 64 * H * D * 2           # its middle rows
    lse_b, mask_b = B * H * n_mid * 64 * 4, B * nb * 64 * 4
    scores = B * H * n_mid * 64 * W
    products = 2.0 * scores * D                # one (bs x W x D) product per block
    out, lse = bigbird_mid_fwd(q, k, v, mask, rand, 64)
    qg, kg, vg, bias = gathered_operands(q, k, v, mask, rand, 64)
    if not backward:
        # q's middle rows, k, v and the mask read; out and lse written
        bound, by = _bound_ms(2 * products, 2 * mid + 2 * tensor + lse_b + mask_b, BF16)
        floor = max(2 * scores / EX2_PER_S, 3 * products / PEAK_FLOPS[BF16]) * 1e3
        fn = lambda: bigbird_mid_fwd(q, k, v, mask, rand, 64)  # noqa: E731
        plain = lambda: bigbird_mid_fwd_plain(q, k, v, mask, rand, 64)  # noqa: E731
        want = plain()[0]
        err = _compare_attn(f"sparse fwd bf16 {label}", fn()[0], want, BF16)
        sdpa_err = float((to_ctx(sdpa_mid(qg, kg, vg, bias), B, H).float() - want.float())
                         .abs().max())
        log(f"# sparse fwd bf16 {label}: SDPA over the gathered operands against the plain "
            f"version: max_abs_err {sdpa_err!r} (not gated: SDPA rounds elsewhere)")
        lib = _time_ms(lambda: sdpa_mid(qg, kg, vg, bias))
    else:
        # q, o, dO middle rows, k, v, lse, mask read; dq (middle), dk, dv written
        bound, by = _bound_ms(5 * products, 4 * mid + 4 * tensor + lse_b + mask_b, BF16)
        floor = max(scores / EX2_PER_S, 7 * products / PEAK_FLOPS[BF16]) * 1e3
        fn = lambda: bigbird_mid_bwd(q, k, v, mask, rand, 64, out, lse, do)  # noqa: E731
        plain = lambda: bigbird_mid_bwd_plain(q, k, v, mask, rand, 64, out, lse, do)  # noqa: E731
        err = max(_compare_grad(f"sparse {n} bf16 {label}", g, w, BF16)
                  for n, g, w in zip(("dq", "dk", "dv"), fn(), plain()))
        lib = _time_sdpa_backward(f"BigBird {label} (gathered)", qg, kg, vg, bias,
                                  torch.randn(qg.shape, generator=gen).to(DEV, BF16))
    t = dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
             bound_ms=bound, bound_by=by, library_ms=lib, floor_ms=floor)
    log(f"# rate bigbird_mid_{'bwd' if backward else 'fwd'} {label}: {t['ms'] / floor!r} x "
        f"the floor, {t['ms'] / lib!r} x SDPA over the gathered operands")
    return t


def phase_prot_timing(cfg: ProtSTonKGsConfig, engine, feats, state, loss_fn) -> dict:
    """Embed sequences/s (B=8), the training step (B=2, median of 6 after
    2 of warm-up), then each new or widened kernel at the ProtSTonKGs
    path's shapes.  Returns per kernel the path shape's numbers."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.embed(feats)
        times.append(time.perf_counter() - t0)
    check(bool(np.isfinite(out).all()), "ProtSTonKGs embed not finite")
    log(f"# ProtSTonKGs embed: {len(out)} rows, B={PROT_BATCH}, seconds {times!r}; best "
        f"{len(out) / min(times)!r} sequences/s, median "
        f"{len(out) / statistics.median(times)!r} sequences/s")
    tx = AdamW(total_steps=1000)
    step = pretraining.make_train_step(cfg, tx, loss_fn=loss_fn, compute_dtype=BF16)
    batch = pretraining.to_device(_prot_features(cfg, PROT_TRAIN_BATCH, seed=4, labels=True),
                                  DEV)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(2 + 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if i >= 2:
            times.append(time.perf_counter() - t0)
        check(math.isfinite(loss), "non-finite ProtSTonKGs loss in the timed steps")
    med = statistics.median(times)
    log(f"# ProtSTonKGs train step B={PROT_TRAIN_BATCH} bf16: seconds {times!r}; median "
        f"{med * 1e3!r} ms, {PROT_TRAIN_BATCH / med!r} sequences/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    del state, step, tx
    gen = torch.Generator().manual_seed(7)
    B, Bt = PROT_BATCH, PROT_TRAIN_BATCH
    cases = [
        ("bigbird_mid_fwd", f"serving B={B} S=4096 eval plan",
         lambda lb: _time_sparse(lb, B, gen, False, "eval")),
        ("bigbird_mid_fwd:train", f"training B={Bt} S=4096 train plan",
         lambda lb: _time_sparse(lb, Bt, gen, False, "train")),
        ("bigbird_mid_bwd", f"training B={Bt} S=4096 train plan",
         lambda lb: _time_sparse(lb, Bt, gen, True, "train")),
        ("ffn_ln_block:prot", f"ProtBERT M={B * cfg.prot_len} H=1024",
         lambda lb: _time_ffn(lb, B * cfg.prot_len, gen, 1024, 4096)),
        ("ffn_ln_block:bigbird", f"trunk M={B * cfg.seq_len} gelu_new",
         lambda lb: _time_ffn(lb, B * cfg.seq_len, gen, act="gelu_new")),
        ("flash_attention_infer:prot", f"ProtBERT B={B} S={cfg.prot_len} H=16 no-bias",
         lambda lb: _time_attention(lb, B, cfg.prot_len, False, gen, H=16)),
        ("ffn_train_fwd:prot", f"ProtBERT M={Bt * cfg.prot_len} H=1024",
         lambda lb: _time_train_ffn(lb, Bt * cfg.prot_len, gen, False, 1024, 4096)),
        ("ffn_train_fwd:bigbird", f"trunk M={Bt * cfg.seq_len} gelu_new",
         lambda lb: _time_train_ffn(lb, Bt * cfg.seq_len, gen, False, act="gelu_new")),
        ("ffn_train_bwd:bigbird", f"trunk M={Bt * cfg.seq_len} gelu_new",
         lambda lb: _time_train_ffn(lb, Bt * cfg.seq_len, gen, True, act="gelu_new")),
        ("ffn_train_fwd:biobert", f"BioBERT M={Bt * cfg.text_len}",
         lambda lb: _time_train_ffn(lb, Bt * cfg.text_len, gen, False)),
        ("flash_attention_train_fwd:prot",
         f"ProtBERT B={Bt} S={cfg.prot_len} H=16 no-bias, rate 0.1",
         lambda lb: _time_train_attention(lb, Bt, cfg.prot_len, False, gen, False, H=16)),
    ]
    result = {}
    for key, label, fn in cases:
        t = fn(label)
        log(f"# time {key.split(':')[0]} {label} bf16: {json.dumps(t)}")
        result[key] = t
    result["bigbird_mid_fwd"]["max_abs_err"] = max(
        result["bigbird_mid_fwd"]["max_abs_err"], result["bigbird_mid_fwd:train"]["max_abs_err"])
    return result


# ---------------------------------------------------------------------------
# int8 serving: the fused int8 dense and the int8 GEMM probe
# ---------------------------------------------------------------------------

INT8_SERVING_KERNELS = {"dense_int8": dense_int8_fused, **SERVING_KERNELS}
PROT_INT8_SERVING_KERNELS = {"dense_int8": dense_int8_fused, **PROT_SERVING_KERNELS}
# (M, K, N) of the int8 paths' denses: the STonKGs trunk (B=128 x 512 rows)
# and backbone (x 256; the ProtSTonKGs BigBird trunk, B=8 x 4096, has the
# same M), ProtBERT (B=8 x 3072) and its projection to 768, and BioBERT in
# ProtSTonKGs (3 text chunks a row: 24 x 256)
INT8_SHAPES = {
    "trunk Q/K/V/O": (65536, 768, 768), "trunk FFN in": (65536, 768, 3072),
    "trunk FFN out": (65536, 3072, 768), "backbone Q/K/V/O": (32768, 768, 768),
    "backbone FFN in": (32768, 768, 3072), "backbone FFN out": (32768, 3072, 768),
    "ProtBERT Q/K/V/O": (24576, 1024, 1024), "ProtBERT FFN in": (24576, 1024, 4096),
    "ProtBERT FFN out": (24576, 4096, 1024), "protein projection": (24576, 1024, 768),
    "BioBERT Q/K/V/O": (6144, 768, 768), "BioBERT FFN in": (6144, 768, 3072),
    "BioBERT FFN out": (6144, 3072, 768),
}
# the [CLS] layers' denses (STonKGs 128 rows, ProtSTonKGs 8), the edges and
# the decoders (N = 28,996, 100,000)
INT8_EDGES = [(128, 768, 768), (128, 768, 3072), (128, 3072, 768), (8, 768, 768),
              (8, 768, 3072), (8, 3072, 768), (0, 768, 768), (1, 768, 768), (300, 768, 3072),
              (64, 768, 100), (128, 768, 28996), (8, 768, 100000),
              # K % 32 == 16: TMA zero-fills the last k32 step
              (300, 48, 100), (1, 784, 100), (128, 48, 28996), (300, 784, 28996)]
# card vs CPU layer by layer (both fp32, int8, each layer fed the CPU's
# input): the share of activation codes that may differ.  A code flips
# where the two fp32 inputs of a dense straddle a rounding boundary, a
# chance of order 1e-5 a code; the bf16 control flips of order 1e-1
INT8_FLIP_LIMIT = 1e-3
GEMM_SIZE = 4096


def _int8_dense_inputs(M, K, N, dtype, gen, zero_row=False):
    """x (M, K) in dtype on the card (row 1 zero with ``zero_row``), an
    int8 (K, N) weight, column-major as the engines hold it, with its fp32
    scales, and an fp32 bias."""
    x = torch.randn(M, K, device=DEV, generator=gen).to(dtype)
    if zero_row and M > 1:
        x[1] = 0
    q = quantize_kernel(0.02 * torch.randn(K, N, device=DEV, generator=gen))
    return (x, k_major(q["kernel_q"]), q["scale"],
            0.02 * torch.randn(N, device=DEV, generator=gen))


def _check_codes(name, x) -> None:
    """The row-quantize pass's codes and scales equal to ``quantize_rows``
    (the plain version, on the card) bit for bit."""
    got_q, got_s = dense_int8_quantize(x)
    want_q, want_s = quantize_rows(x.reshape(-1, x.shape[-1]))
    torch.cuda.synchronize()
    flips = int((got_q != want_q).sum())
    same_s = torch.equal(got_s, want_s.reshape(-1))
    log(f"# check {name} codes and scales: {flips} of {want_q.numel()} codes differ, scales "
        f"{'equal' if same_s else 'DIFFER'} {'ok' if flips == 0 and same_s else 'FAIL'}")
    check(flips == 0 and same_s, f"{name}: the row-quantize pass differs from quantize_rows")


def _int8_limits_reject(gen) -> None:
    """The phase's limits against two known faults, applied to the plain
    version: codes made with a reciprocal (x * (1 / s) instead of x / s)
    differ from the pass's exact codes and move the fp32 output past
    INT8_F32_TOL; an epilogue without s_w fails the bf16 tolerance."""
    M, K, N = INT8_SHAPES["trunk FFN out"]
    x, w, s, b = _int8_dense_inputs(M, K, N, F32, gen)
    q, sx = quantize_rows(x)
    recip = torch.clamp(torch.round(x * torch.reciprocal(sx)), -127, 127).to(I8)
    flips = int((recip != q).sum())
    log(f"# check dense_int8 fault: codes with a reciprocal at M={M} {K}->{N} fp32: {flips} of "
        f"{q.numel()} codes differ from the exact ones {'rejected: ok' if flips else 'FAIL'}")
    check(flips > 0, "the exact code check does not catch codes made with a reciprocal")
    want = _dequant_plain(q, sx, w, s, b, F32)
    err = float((_dequant_plain(recip, sx, w, s, b, F32) - want).abs().max())
    limit = INT8_F32_TOL * float(want.abs().max())
    log(f"# check dense_int8 fault: its fp32 output: max_abs_err {err!r} limit {limit!r} "
        f"{'passes: FAIL' if err <= limit else 'rejected: ok'}")
    check(err > limit, "the fp32 limit does not catch codes made with a reciprocal")
    del x, q, recip, want
    x, w, s, b = _int8_dense_inputs(300, 768, 768, BF16, gen)
    want = dense_int8_fused_plain(x, w, s, b)
    q, sx = quantize_rows(x)
    wrong = _dequant_plain(q, sx, w, torch.ones_like(s), b, BF16)
    ok = bool(torch.allclose(wrong.float(), want.float(), **TOL[BF16]))
    log(f"# check dense_int8 fault: epilogue without s_w, bf16 M=300: max_abs_err "
        f"{float((wrong.float() - want.float()).abs().max())!r} "
        f"{'passes: FAIL' if ok else 'rejected: ok'}")
    check(not ok, "the bf16 tolerance does not catch an epilogue without s_w")


def _compare_int8(name, got, want, dtype) -> float:
    """bf16: within TOL[BF16]; fp32: within INT8_F32_TOL of max |want|."""
    if dtype == BF16:
        return _compare(name, got, want, dtype)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    limit = INT8_F32_TOL * (float(want.abs().max()) if want.numel() else 0.0)
    log(f"# check {name}: max_abs_err {err!r} limit {limit!r} {'ok' if err <= limit else 'FAIL'}")
    check(err <= limit, f"{name}: kernel disagrees with its plain version")
    return err


def phase_int8_kernels() -> dict:
    """The int8 dense vs its plain version on the card, bf16 and fp32, at
    the paths' shapes and the edges, its row-quantize pass's codes and
    scales bit for bit, and the limits against two known faults; the GEMM
    probe exactly equal to its plain version (int8), within tolerance
    (bf16).  Returns the worst bf16 error at the paths' shapes."""
    gen = torch.Generator(device=DEV).manual_seed(20)
    errs = {"dense_int8": 0.0}
    for dtype in (BF16, F32):
        tag = "bf16" if dtype == BF16 else "fp32"
        for M, K, N in [*INT8_SHAPES.values(), *INT8_EDGES]:
            x, w, s, b = _int8_dense_inputs(M, K, N, dtype, gen, zero_row=True)
            _check_codes(f"dense_int8 {tag} M={M} K={K}", x)
            e = _compare_int8(f"dense_int8 {tag} M={M} {K}->{N} zero row",
                              dense_int8_fused(x, w, s, b), dense_int8_fused_plain(x, w, s, b),
                              dtype)
            if dtype == BF16 and (M, K, N) in INT8_SHAPES.values():
                errs["dense_int8"] = max(errs["dense_int8"], e)
            del x, w, s, b
        x, w, s, _ = _int8_dense_inputs(300, 768, 768, dtype, gen)
        _compare_int8(f"dense_int8 {tag} M=300 no bias", dense_int8_fused(x, w, s),
                      dense_int8_fused_plain(x, w, s), dtype)
        # the [CLS] rows of the trunk's (B, S, H) activation: a strided view
        h = torch.randn(BATCH, 512, 768, device=DEV, generator=gen).to(dtype)[:, :1]
        _compare_int8(f"dense_int8 {tag} x[:, :1] of ({BATCH}, 512, 768)",
                      dense_int8_fused(h, w, s), dense_int8_fused_plain(h.contiguous(), w, s),
                      dtype)
        _check_codes(f"dense_int8 {tag} x[:, :1]", h)
        # a row-major weight: correct, through a K-major copy made for the call
        w_row = w.contiguous()
        _compare_int8(f"dense_int8 {tag} M=300 row-major kernel_q", dense_int8_fused(x, w_row, s),
                      dense_int8_fused_plain(x, w_row, s), dtype)
        del h, w_row
    _int8_limits_reject(gen)
    ops = bench_int8_gemm.operands(GEMM_SIZE, GEMM_SIZE, GEMM_SIZE)
    errs["int8_gemm"] = 0.0
    for a, b in ((ops["a8"][:512, :1024], ops["b8"][:1024, :512]), (ops["a8"], ops["b8"])):
        err = _gemm_int8_err(a, b)
        log(f"# check int8_gemm int8 {tuple(a.shape)} x {tuple(b.shape)}: max_abs_err {err!r} "
            f"(exactly equal)")
        check(err == 0, "int8_gemm: int8 result differs from its plain version")
        errs["int8_gemm"] = max(errs["int8_gemm"], err)
    errs["int8_gemm"] = max(errs["int8_gemm"], _compare_rel(
        f"int8_gemm bf16 {GEMM_SIZE}^3", int8_gemm(ops["abf"], ops["bbf"]),
        int8_gemm_plain(ops["abf"], ops["bbf"]), F32))
    return errs


def _gemm_int8_err(a, b) -> float:
    """max |kernel - plain| of the probe's int8 product (exact in fp64)."""
    got, want = int8_gemm(a, b), int8_gemm_plain(a, b)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype == torch.int32 and got.shape == want.shape,
          f"int8_gemm: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    return float((got.double() - want.double()).abs().max())


def _time_embed_in_turns(label: str, engines: dict, feats: dict, unit: str) -> dict:
    """Each engine's embed 3 times, in turns; logs rows/s and returns the
    last outputs by name."""
    times = {name: [] for name in engines}
    outs = {}
    for _ in range(3):
        for name, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = eng.embed(feats)
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        n = len(outs[name])
        check(bool(np.isfinite(outs[name]).all()), f"{label} {name} embed not finite")
        log(f"# embed {label} {name}: {n} rows, B={engines[name].batch_size}, seconds {ts!r}; "
            f"best {n / min(ts)!r} {unit}, median {n / statistics.median(ts)!r} {unit}")
    return outs


def phase_int8_serving(cfg: STonKGsConfig, params: dict, feats: dict) -> dict:
    """``quantize_params`` on phase 5's fp32 parameters (KG table
    included), then ``STonKGsEngine.embed`` in bf16 on the card: the
    int8 main path, counts from 0 just before it.  Then card fp32 vs CPU
    fp32 (both int8) on 4 rows, card bf16 vs CPU fp32, and pairs/s in
    turns with the bf16 engine.  Returns the launch counts.

    End to end, the 0.9999 cosine holds at 2 layers a stack (full
    width).  At full depth a code that flips in one layer (the card's
    and the CPU's fp32 inputs of a dense straddling a rounding boundary)
    moves every later layer's input, so there the end-to-end cosine is
    logged, held only at 0.999 against gross faults, and the precision
    is held layer by layer (:func:`_int8_layers_card_vs_cpu`)."""
    t0 = time.perf_counter()
    params_q = quantize_params(params_to(params, DEV))
    engine = STonKGsEngine(cfg=cfg, params=params_to(params_q, DEV, BF16), batch_size=BATCH,
                           device=DEV)
    log(f"# int8 serving setup (quantize on the card): {time.perf_counter() - t0:.1f} s")
    _check_k_major("STonKGs int8 engine", engine.params)
    _reset_counts(INT8_SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(INT8_SERVING_KERNELS)
    n_batches = math.ceil(ROWS / BATCH)
    layers = cfg.bert.num_hidden_layers
    # 6 denses a layer: the backbone's L layers, the trunk's L - 1 full
    # layers and its [CLS] layer; attention in every full layer
    per_batch = {"dense_int8": 6 * 2 * layers, "flash_attention_infer": 2 * layers - 1,
                 "ffn_ln_block": 0}
    log(f"# launches int8 parity embed ({n_batches} batches): {counts}")
    check(out.shape == (ROWS, cfg.bert.hidden_size), f"int8 embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "int8 embed output not finite")
    for name, c in per_batch.items():
        check(counts[name] == c * n_batches,
              f"{name}: {counts[name]} launches, expected {c} x {n_batches}")

    # numerics on 4 rows: card fp32 vs CPU fp32 (both int8) at 2 layers a
    # stack of the full width, then at full depth layer by layer and end
    # to end, and card bf16 vs CPU fp32
    few = {k: v[:4] for k, v in feats.items()}

    def embed32(p, device, c=cfg):
        return STonKGsEngine(cfg=c, params=p, compute_dtype="float32", batch_size=4,
                             device=device).embed(few)

    small = cfg.replace(bert=dataclasses.replace(cfg.bert, num_hidden_layers=2))
    q2 = {**params_q, **{k: {**params_q[k], "encoder": params_q[k]["encoder"][:2]}
                         for k in ("trunk", "lm_backbone")}}
    cos2 = _cosine(embed32(q2, DEV, small), embed32(params_to(q2, "cpu"), "cpu", small))
    log(f"# int8 card fp32 vs CPU fp32 (4 rows, 2 layers a stack): cosine {cos2.tolist()!r} "
        f"(limit 0.9999)")
    check(bool((cos2 >= 0.9999).all()), "int8 card fp32 disagrees with the CPU (2 layers)")
    cpu32 = _int8_layers_card_vs_cpu(lambda p: embed32(p, "cpu"), params_q)
    card32 = embed32(params_q, DEV)
    cos32, cos16 = _cosine(card32, cpu32), _cosine(out[:4], cpu32)
    log(f"# int8 card fp32 vs CPU fp32 (4 rows, {layers} layers end to end): cosine "
        f"{cos32.tolist()!r}, max_abs_err {float(np.abs(card32 - cpu32).max())!r} "
        f"(limit 0.999)")
    log(f"# int8 card bf16 vs CPU fp32 (4 rows, {layers} layers end to end): cosine "
        f"{cos16.tolist()!r} (limit 0.99)")
    check(bool((cos32 >= 0.999).all()), "int8 card fp32 disagrees with the CPU")
    check(bool((cos16 >= 0.99).all()), "int8 card bf16 too far from the CPU fp32")
    del params_q, q2, card32
    bf16 = STonKGsEngine(cfg=cfg, params=params_to(params, DEV, BF16), batch_size=BATCH,
                         device=DEV)
    outs = _time_embed_in_turns("STonKGs parity", {"bf16": bf16, "int8": engine}, feats,
                                "pairs/s")
    cos = _cosine(outs["int8"], outs["bf16"])
    log(f"# int8 vs bf16 embeddings ({ROWS} rows, random weights, not gated): cosine mean "
        f"{float(cos.mean())!r} min {float(cos.min())!r}")
    return counts


def _check_k_major(name: str, params) -> None:
    """Every quantized dense of an engine's parameters holds its weight
    column-major on the card, so the timed path never copies W."""
    leaves = []
    tree_map(lambda p: leaves.append(p) or p, params, is_leaf=is_quantized)
    dense = [p["kernel_q"] for p in leaves if is_quantized(p)]
    bad = sum(1 for w in dense if w.device.type != "cuda" or not w.t().is_contiguous())
    log(f"# {name}: {len(dense)} quantized weights, {bad} not column-major on the card")
    check(bool(dense) and bad == 0, f"{name}: a quantized weight is not column-major")


@contextlib.contextmanager
def _wrapped(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _recording_codes(store: list):
    """A wrapper of ``dense_int8`` that keeps each input's row codes."""
    def wrap(fn):
        def run(x, p):
            store.append(quantize_rows(x)[0].cpu())
            return fn(x, p)
        return run
    return wrap


def _int8_layers_card_vs_cpu(embed_cpu, params_q: dict) -> np.ndarray:
    """Card vs CPU, one encoder layer at a time, at full depth.

    ``embed_cpu(params)`` runs the int8 model in fp32 on the CPU; every
    encoder layer it runs (the backbone's, the trunk's and its [CLS]
    layer) is kept with its input, its output and the row codes of each
    of its denses' inputs.  Each layer then runs again on the card from
    the CPU's input, in fp32 and in bf16 (the control).  Per layer: the
    least cosine over tokens and the share of codes that differ from the
    CPU's.  fp32 must keep every layer's cosine at 0.9999 and its flips
    under :data:`INT8_FLIP_LIMIT`; the bf16 control must exceed that
    limit, or the count could not tell fp32 from bf16.  Returns the CPU's
    embeddings."""
    calls, codes = [], []

    def record(fn):
        def run(x, lp, c, bias, **kw):
            start = len(codes)
            y = fn(x, lp, c, bias, **kw)
            calls.append((fn, x, lp, c, bias, kw, y, codes[start:]))
            return y
        return run

    with _wrapped(bert, "encoder_layer", record), _wrapped(bert, "encoder_layer_cls", record), \
            _wrapped(bert, "dense_int8", _recording_codes(codes)):
        cpu32 = embed_cpu(params_to(params_q, "cpu"))
    del codes
    rows = {"fp32": [], "bf16": []}
    for fn, x, lp, c, bias, kw, want, want_codes in calls:
        for tag, dtype in (("fp32", F32), ("bf16", BF16)):
            got_codes = []
            with _wrapped(bert, "dense_int8", _recording_codes(got_codes)):
                got = fn(x.to(DEV, dtype), params_to(lp, DEV, dtype), c,
                         None if bias is None else bias.to(DEV), **kw)
            check(len(got_codes) == len(want_codes), "layer runs a different number of denses")
            flips = sum(int((g != w).sum()) for g, w in zip(got_codes, want_codes))
            n = sum(w.numel() for w in want_codes)
            H = want.shape[-1]
            cos = _cosine(got.float().cpu().reshape(-1, H).numpy(), want.reshape(-1, H).numpy())
            rows[tag].append((float(cos.min()), flips / n, flips, n))
    for tag, r in rows.items():
        log(f"# int8 card {tag} vs CPU fp32, each of {len(r)} layers fed the CPU's input "
            f"(backbone, then trunk): least cosine over tokens {[c for c, *_ in r]!r}; "
            f"codes flipped {[f for _, _, f, _ in r]!r} of {[n for *_, n in r]!r}")
    worst_cos = min(c for c, *_ in rows["fp32"])
    worst_flip = max(f for _, f, *_ in rows["fp32"])
    least_flip16 = min(f for _, f, *_ in rows["bf16"])
    log(f"# int8 layer by layer: fp32 least cosine {worst_cos!r} (limit 0.9999), most "
        f"flipped share {worst_flip!r} (limit {INT8_FLIP_LIMIT}); bf16 control least flipped "
        f"share {least_flip16!r} (must exceed the limit)")
    check(worst_cos >= 0.9999, "an int8 layer on the card in fp32 disagrees with the CPU")
    check(worst_flip <= INT8_FLIP_LIMIT, "an int8 layer on the card flips too many codes")
    check(least_flip16 > INT8_FLIP_LIMIT, "the flip count does not tell fp32 from bf16")
    return cpu32


def phase_prot_int8_serving(cfg: ProtSTonKGsConfig, params: dict, bf16_engine, feats) -> dict:
    """``ProtSTonKGsEngine.embed`` with quantized parameters at full
    width (B=8, 32 rows): the int8 main path, counts from 0 just before
    it; then at 2 layers a stack card fp32 and bf16 vs CPU fp32 (all
    int8), and sequences/s in turns with the bf16 engine.  Returns the
    launch counts."""
    t0 = time.perf_counter()
    engine = ProtSTonKGsEngine(cfg=cfg, params=params_to(quantize_params(params_to(params, DEV)),
                                                         DEV, BF16),
                               batch_size=PROT_BATCH, device=DEV)
    log(f"# ProtSTonKGs int8 serving setup: {time.perf_counter() - t0:.1f} s")
    _check_k_major("ProtSTonKGs int8 engine", engine.params)
    _reset_counts(PROT_INT8_SERVING_KERNELS)
    out = engine.embed(feats)
    counts = _counts(PROT_INT8_SERVING_KERNELS)
    n_batches = math.ceil(PROT_ROWS / PROT_BATCH)
    t, lm, prot = cfg.trunk, cfg.lm, cfg.prot
    # 6 denses a layer in the LM and protein backbones and the trunk (its
    # [CLS] layer included), and the protein projection
    per_batch = {"dense_int8": 6 * (lm.num_hidden_layers + prot.num_hidden_layers
                                    + t.num_hidden_layers) + 1,
                 "flash_attention_infer": lm.num_hidden_layers + prot.num_hidden_layers,
                 "bigbird_mid_fwd": t.num_hidden_layers - 1, "ffn_ln_block": 0}
    log(f"# launches ProtSTonKGs int8 embed ({n_batches} batches of {PROT_BATCH}): {counts}")
    check(out.shape == (PROT_ROWS, t.hidden_size), f"ProtSTonKGs int8 embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "ProtSTonKGs int8 embed output not finite")
    for name, c in per_batch.items():
        check(counts[name] == c * n_batches,
              f"{name}: {counts[name]} launches, expected {c} x {n_batches}")

    small = _prot_cfg(cfg.kg_vocab_size, layers=2)
    q32 = quantize_params(params_to(_prot_params(small, seed=11), DEV))
    few = _prot_features(small, 2, seed=1)
    card32 = ProtSTonKGsEngine(cfg=small, params=q32, compute_dtype="float32", batch_size=2,
                               device=DEV).embed(few)
    card16 = ProtSTonKGsEngine(cfg=small, params=params_to(q32, DEV, BF16), batch_size=2,
                               device=DEV).embed(few)
    cpu32 = ProtSTonKGsEngine(cfg=small, params=params_to(q32, "cpu"), compute_dtype="float32",
                              batch_size=2, device="cpu").embed(few)
    cos32, cos16 = _cosine(card32, cpu32), _cosine(card16, cpu32)
    log(f"# ProtSTonKGs int8 card fp32 vs CPU fp32 (2 rows, 2 layers a stack): cosine "
        f"{cos32.tolist()!r}, max_abs_err {float(np.abs(card32 - cpu32).max())!r} "
        f"(limit: cosine 0.9999)")
    log(f"# ProtSTonKGs int8 card bf16 vs CPU fp32: cosine {cos16.tolist()!r} (limit 0.99)")
    check(bool((cos32 >= 0.9999).all()), "ProtSTonKGs int8 card fp32 disagrees with the CPU")
    check(bool((cos16 >= 0.99).all()), "ProtSTonKGs int8 card bf16 too far from the CPU fp32")
    del q32
    outs = _time_embed_in_turns("ProtSTonKGs", {"bf16": bf16_engine, "int8": engine}, feats,
                                "sequences/s")
    cos = _cosine(outs["int8"], outs["bf16"])
    log(f"# ProtSTonKGs int8 vs bf16 embeddings (random weights, not gated): cosine mean "
        f"{float(cos.mean())!r} min {float(cos.min())!r}")
    return counts


def phase_int8_timing():
    """The int8 dense at each path shape (held against its plain version
    there, then timed) beside its bound, its plain version and two
    references: ``torch._int_mm`` on codes made beforehand and the
    column-major weight (the GEMM alone) and the bf16 dense ``x @ W + b``
    that the int8 mode replaces; then its two launches apart, the
    row-quantize pass and the GEMM, each beside its own bound, whose sum
    is the two-pass design's floor.  Then the probe's ``main`` at 4096^3,
    counts from 0 just before it.  Returns the per-shape numbers, the
    probe's kernel-line numbers and its launch count."""
    gen = torch.Generator(device=DEV).manual_seed(21)
    result = {}
    for label, (M, K, N) in INT8_SHAPES.items():
        x, w, s, b = _int8_dense_inputs(M, K, N, BF16, gen)
        bound, by = _bound_ms(2.0 * M * K * N, M * K * 2 + K * N + 2 * N * 4 + M * N * 2, I8)
        pass_bound, _ = _bound_ms(0.0, M * K * 2 + M * K + M * 4, I8)
        gemm_bound, gemm_by = _bound_ms(2.0 * M * K * N,
                                        M * K + M * 4 + K * N + 2 * N * 4 + M * N * 2, I8)
        err = _compare(f"dense_int8 bf16 {label} M={M} {K}->{N}", dense_int8_fused(x, w, s, b),
                       dense_int8_fused_plain(x, w, s, b), BF16)
        codes, scales = dense_int8_quantize(x)
        wb, bb = (w.float() * s).to(BF16), b.to(BF16)
        t = dict(max_abs_err=err, ms=_time_ms(lambda: dense_int8_fused(x, w, s, b)),
                 plain_ms=_time_ms(lambda: dense_int8_fused_plain(x, w, s, b), iters=3),
                 bound_ms=bound, bound_by=by, library_ms=None,
                 pass_ms=_time_ms(lambda: dense_int8_quantize(x)), pass_bound_ms=pass_bound,
                 gemm_ms=_time_ms(lambda: dense_int8_gemm(codes, scales, w, s, b, BF16)),
                 gemm_bound_ms=gemm_bound, gemm_bound_by=gemm_by,
                 floor_ms=pass_bound + gemm_bound,
                 int_mm_ms=_time_ms(lambda: torch._int_mm(codes, w)),
                 bf16_dense_ms=_time_ms(lambda: x @ wb + bb))
        log(f"# time dense_int8 {label} M={M} {K}->{N} bf16: {json.dumps(t)}")
        log(f"# rate dense_int8 {label}: {2.0 * M * K * N / (t['ms'] * 1e-3) / 1e12!r} TOP/s; "
            f"GEMM alone {2.0 * M * K * N / (t['gemm_ms'] * 1e-3) / 1e12!r} TOP/s; "
            f"{t['ms'] / t['floor_ms']!r} x the floor, {t['ms'] / t['bf16_dense_ms']!r} x the "
            f"bf16 dense")
        result[label] = t
        del x, w, s, b, codes, scales, wb, bb
    ops = bench_int8_gemm.operands(GEMM_SIZE, GEMM_SIZE, GEMM_SIZE)
    err = _gemm_int8_err(ops["a8"], ops["b8"])
    check(err == 0, "int8_gemm: int8 result differs from its plain version")
    int8_gemm.launches = 0
    try:
        variants = bench_int8_gemm.main(GEMM_SIZE)
    except RuntimeError as e:
        raise SmokeFailure(f"int8 GEMM probe: {e}") from e
    launches = int8_gemm.launches
    log(f"# launches int8 GEMM probe main: {launches}")
    check(launches > 0, "the probe launched no kernel")
    n = GEMM_SIZE
    bound, by = _bound_ms(2.0 * n ** 3, 2 * n * n + 4 * n * n, I8)
    gemm = dict(max_abs_err=err, ms=variants["kernel int8"]["ms"],
                plain_ms=_time_ms(lambda: int8_gemm_plain(ops["a8"], ops["b8"]), iters=3),
                bound_ms=bound, bound_by=by, library_ms=variants["torch int8"]["ms"])
    log(f"# time int8_gemm {n}^3 int8: {json.dumps(gemm)}")
    return result, gemm, launches


def main() -> int:
    try:
        card = phase_device()
        phase_build()
        errs = phase_kernels()
        errs.update(phase_train_kernels())
        cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=100_000)
        engine, bucketed, feats, counts, params = phase_serving(cfg)
        times = phase_timing(cfg, engine, bucketed, feats)
        del engine, bucketed
        train_counts, state = phase_training(cfg, params)
        counts.update(train_counts)
        phase_train_numerics(cfg)
        times.update(phase_train_timing(cfg, state))
        del state          # params (CPU, fp32) stay for the int8 path
        errs.update(phase_sparse_kernels())
        pcfg = _prot_cfg()
        engine, pfeats, prot_counts, pparams = phase_prot_serving(pcfg)
        for name, c in prot_counts.items():
            counts[name] = counts.get(name, 0) + c
        prot_train_counts, pstate, loss_fn = phase_prot_training(pcfg, pparams)
        for name, c in prot_train_counts.items():
            counts[name] = counts.get(name, 0) + c
        phase_prot_train_numerics(pcfg)
        prot_times = phase_prot_timing(pcfg, engine, pfeats, pstate, loss_fn)
        del pstate, loss_fn
        for name in ("bigbird_mid_fwd", "bigbird_mid_bwd"):
            times[name] = prot_times[name]
        for name in ("ffn_ln_block", "flash_attention_infer", "ffn_train_fwd", "ffn_train_bwd",
                     "flash_attention_train_fwd"):
            times[name]["max_abs_err"] = max(times[name]["max_abs_err"], *(
                t["max_abs_err"] for k, t in prot_times.items() if k.startswith(name + ":")))
        errs.update(phase_int8_kernels())
        int8_counts = phase_int8_serving(cfg, params, feats)
        del params
        for counted in (int8_counts, phase_prot_int8_serving(pcfg, pparams, engine, pfeats)):
            for name, c in counted.items():
                counts[name] = counts.get(name, 0) + c
        del engine, pparams
        int8_times, times["int8_gemm"], counts["int8_gemm"] = phase_int8_timing()
        # the trunk's FFN-in shape goes into the kernel line, with the
        # worst error of every path shape
        times["dense_int8"] = dict(int8_times["trunk FFN in"], max_abs_err=max(
            t["max_abs_err"] for t in int8_times.values()))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    attn_cu = "stonkgs_tpu_torch/csrc/flash_attention_train.cu"
    ffn_cu = "stonkgs_tpu_torch/csrc/ffn_train.cu"
    sparse_cu = "stonkgs_tpu_torch/csrc/bigbird_sparse.cu"
    sources = {"ffn_ln_block": ("stonkgs_tpu_torch/csrc/ffn_ln_block.cu",
                                "stonkgs_tpu/ops/fused_ffn.py:438"),
               "flash_attention_infer": ("stonkgs_tpu_torch/csrc/flash_attention_infer.cu",
                                         "stonkgs_tpu/ops/flash_attention.py:359"),
               "flash_attention_train_fwd": (attn_cu, "stonkgs_tpu/ops/flash_attention.py:92"),
               "flash_attention_train_bwd": (attn_cu, "stonkgs_tpu/ops/flash_attention.py:118"),
               "ffn_train_fwd": (ffn_cu, "stonkgs_tpu/ops/fused_ffn.py:54"),
               "ffn_train_bwd": (ffn_cu, "stonkgs_tpu/ops/fused_ffn.py:206"),
               "bigbird_mid_fwd": (sparse_cu, "stonkgs_tpu/ops/bigbird_sparse_pallas.py:83"),
               "bigbird_mid_bwd": (sparse_cu, "stonkgs_tpu/ops/bigbird_sparse_pallas.py:113"),
               "dense_int8": ("stonkgs_tpu_torch/csrc/dense_int8.cu",
                              "stonkgs_tpu/ops/quantization_pallas.py:33"),
               "int8_gemm": ("stonkgs_tpu_torch/csrc/int8_gemm.cu",
                             "benchmarks/bench_int8_gemm.py:27")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in sources:
        src, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        **{k: times[name][k] for k in keys},
                        "max_abs_err": max(errs[name], times[name]["max_abs_err"])})
    log(f"# card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
