"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: the card's name and power limit (nvidia-smi); CUDA must exist;
2. build: every CUDA source of ``stonkgs_tpu_torch/csrc`` with nvcc, all
   started together, with ptxas's register and spill report;
3. kernels: the serving kernels against their plain PyTorch versions on
   the card, in bf16 and fp32, at the serving path's shapes;
4. training kernels: the attention pair (rate 0 and 0.1, S = 1, 260, 512,
   1024) and the FFN pair (M = 0, 3, 8,192, 16,384), forward and
   backward, against their plain versions, in bf16 and fp32;
5. serving: ``STonKGsEngine.embed`` at full BERT-base width (backbone and
   trunk, 256 + 256, KG vocabulary 100,000, random seeded weights) on 512
   rows, in parity mode and with ``length_buckets=(64, 128)``; checks the
   kernels' launch counts, finite output, the card in fp32 against the
   CPU in fp32, and the card in bf16 against the CPU in fp32;
6. timing: embed throughput, and each serving kernel's time at the path's
   shapes beside its bound, its plain version and PyTorch's SDPA;
7. training: ``pretrain`` at full width (B=32, fp32 parameters, bf16
   compute, synthetic batches with int(0.15*len) masked positions per
   half); checks the training kernels' launch counts, a finite loss at
   every step, the frozen backbones bit-unchanged and the trainable
   parameters changed;
8. training numerics: the loss and trunk gradients on the card in fp32
   against the CPU in fp32 (2 rows, 2 layers, attention dropout 0.1 with
   the same seeds, hidden dropout 0);
9. training timing: ms per step and examples/s (median of 6 steps after 2
   of warm-up), and each training kernel's time at the step's shapes
   beside its bound, its plain version and, for attention, SDPA.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from stonkgs_tpu_torch import STonKGsEngine
from stonkgs_tpu_torch.config import BertConfig, STonKGsConfig
from stonkgs_tpu_torch.models import stonkgs
from stonkgs_tpu_torch.ops import _build
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
    fused_ffn_bwd,
    fused_ffn_bwd_plain,
    fused_ffn_fwd,
    fused_ffn_ln_block,
    fused_ffn_ln_block_plain,
    fused_ffn_plain,
)
from stonkgs_tpu_torch.train import pretraining
from stonkgs_tpu_torch.train.optimizer import AdamW, split_frozen
from stonkgs_tpu_torch.utils.convert import params_to
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

DEV = "cuda"
BF16 = torch.bfloat16
F32 = torch.float32
# H100 SXM data-sheet peaks (dense): tensor-core bf16, fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {BF16: 989e12, F32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain on the card: fp32 sums run in another order; bf16 may
# round an intermediate or the output to the other neighbour (one bf16
# step is 2^-7 relative)
TOL = {F32: dict(atol=1e-4, rtol=0.0), BF16: dict(atol=2e-2, rtol=1e-2)}
# gradients and backward outputs are sums over up to 1,024 rows of
# products of rounded operands, so their error grows with their size:
# the tolerance is relative to the largest value (fp32: sums in another
# order; bf16: an operand rounded to the other neighbour, one step 2^-8)
GRAD_TOL = {F32: 1e-4, BF16: 2e-2}
SOURCES = ("ffn_ln_block", "flash_attention_infer", "flash_attention_train", "ffn_train")
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
                err = _compare(
                    f"attention {tag} B=8 S={S} {'mask' if masked else 'no-bias'}",
                    flash_attention_infer(q, k, v, bias),
                    flash_attention_infer_plain(q, k, v, bias), dtype)
                if dtype == BF16 and S == 512:
                    errs["flash_attention_infer"] = max(
                        errs.get("flash_attention_infer", 0.0), err)
        for M in (3, 1000, 32768):
            for act in ("gelu", "gelu_new"):
                if act == "gelu_new" and M != 1000:
                    continue
                args = _ffn_inputs(M, dtype, gen)
                err = _compare(
                    f"ffn_ln {tag} M={M} {act}",
                    fused_ffn_ln_block(*args, act=act),
                    fused_ffn_ln_block_plain(*args, act=act), dtype)
                if dtype == BF16 and M == 32768:
                    errs["ffn_ln_block"] = err
    return errs


def _train_attn_inputs(B, S, dtype, gen, masked=True):
    """q, k, v, bias, keep, a two-word seed and an output cotangent."""
    q, k, v, bias, keep = _attn_inputs(B, S, dtype, gen, masked)
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32, generator=gen)
    do = torch.randn(B, S, 12, 64, generator=gen).to(DEV, dtype)
    return q, k, v, bias, keep, seed, do


def _train_ffn_inputs(M, dtype, gen, H=768, I=3072):
    """x, w1, b1, w2, b2 (fp32 weights, as the model's parameters) and a
    cotangent g."""
    def n(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen)).to(DEV)
    return (n(M, H).to(dtype), n(H, I, std=0.02), n(I, std=0.02), n(I, H, std=0.02),
            n(H, std=0.02), n(M, H).to(dtype))


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
                q, k, v, bias, _, seed, do = _train_attn_inputs(B, S, dtype, gen)
                label = f"{tag} B={B} S={S} rate={rate}"
                out, lse = flash_attention_train_fwd(q, k, v, bias, seed, rate)
                out_p, lse_p = flash_attention_train_fwd_plain(q, k, v, bias, seed, rate)
                e = max(_compare(f"attention fwd {label}", out, out_p, dtype),
                        _compare(f"attention lse {label}", lse, lse_p, F32))
                note("flash_attention_train_fwd", e, dtype, S == 512)
                # both backwards from the plain forward's out and lse
                got = flash_attention_train_bwd(q, k, v, bias, out_p, lse_p, do, seed, rate)
                want = flash_attention_train_bwd_plain(q, k, v, bias, out_p, lse_p, do,
                                                       seed, rate)
                e = max(_compare_rel(f"attention {n} {label}", g, w, dtype if n != "db" else F32)
                        for n, g, w in zip(("dq", "dk", "dv", "db"), got, want))
                note("flash_attention_train_bwd", e, dtype, S == 512)
        for M in (0, 3, 8192, 16384):
            for act in ("gelu", "gelu_new") if M == 3 else ("gelu",):
                x, w1, b1, w2, b2, g = _train_ffn_inputs(M, dtype, gen)
                label = f"{tag} M={M} {act}"
                e = _compare(f"ffn fwd {label}", fused_ffn_fwd(x, w1, b1, w2, b2, act=act),
                             fused_ffn_plain(x, w1, b1, w2, b2, act=act), dtype)
                note("ffn_train_fwd", e, dtype, M == 16384)
                got = fused_ffn_bwd(x, g, w1, b1, w2, act=act)
                want = fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)
                e = max(_compare_rel(f"ffn dx {label}", got[0], want[0], dtype),
                        _compare_rel(f"ffn dh {label}", got[1], want[1], dtype),
                        _compare(f"ffn a {label}", got[2], want[2], dtype))
                note("ffn_train_bwd", e, dtype, M == 16384)
    return errs


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


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def _time_ffn(label: str, M: int, gen) -> dict:
    """Kernel vs plain at the main path's shape, then both timed."""
    args = _ffn_inputs(M, BF16, gen)
    H, I = args[4].shape
    flops = 4.0 * M * H * I
    nbytes = (3 * M * H + 2 * H * I) * 2 + (5 * H + I) * 4
    bound, by = _bound_ms(flops, nbytes, BF16)
    err = _compare(f"ffn_ln bf16 {label}", fused_ffn_ln_block(*args),
                   fused_ffn_ln_block_plain(*args), BF16)
    return dict(max_abs_err=err,
                ms=_time_ms(lambda: fused_ffn_ln_block(*args)),
                plain_ms=_time_ms(lambda: fused_ffn_ln_block_plain(*args), iters=3),
                bound_ms=bound, bound_by=by, library_ms=None)


def _time_attention(label: str, B: int, S: int, masked: bool, gen) -> dict:
    """Kernel vs plain at the main path's shape, then both and SDPA timed."""
    q, k, v, bias, keep = _attn_inputs(B, S, BF16, gen, masked)
    H, D = q.shape[2], q.shape[3]
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * B * S * H * D * 2 + (B * S * 4 if masked else 0)
    bound, by = _bound_ms(flops, nbytes, BF16)
    err = _compare(f"attention bf16 {label}", flash_attention_infer(q, k, v, bias),
                   flash_attention_infer_plain(q, k, v, bias), BF16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # views, no copy
    mask = None if keep is None else keep[:, None, None, :]
    return dict(max_abs_err=err,
                ms=_time_ms(lambda: flash_attention_infer(q, k, v, bias)),
                plain_ms=_time_ms(lambda: flash_attention_infer_plain(q, k, v, bias),
                                  iters=3),
                bound_ms=bound, bound_by=by,
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)))


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


def phase_train_numerics(cfg_full: STonKGsConfig) -> None:
    """Loss and trunk gradients, card fp32 vs CPU fp32, at 2 rows and 2
    layers of the full width, hidden dropout 0 and attention dropout 0.1:
    the attention seeds come from the same CPU generator on both sides."""
    bert = dataclasses.replace(cfg_full.bert, num_hidden_layers=2, hidden_dropout_prob=0.0)
    cfg = cfg_full.replace(bert=bert)
    gen = torch.Generator().manual_seed(5)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    params["kg_backbone"] = torch.randn(cfg.kg_table_size, bert.hidden_size, generator=gen)
    feats = _pretraining_features(cfg, 2, seed=7)

    def loss_and_grads(device):
        p = params_to(params, device)
        leaves = tree_leaves(p["trunk"])
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = stonkgs.pretraining_loss(
            p, cfg, pretraining.to_device(feats, device), deterministic=False,
            rng=pretraining.step_rng(0, 0, device), compute_dtype=F32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
        # the trunk's word embeddings take no part (it reads the backbones')
        return float(loss.detach()), [g.detach().cpu() for g in grads if g is not None]

    launches = flash_attention_train_fwd.launches
    loss_card, g_card = loss_and_grads(DEV)
    check(flash_attention_train_fwd.launches > launches, "the card run launched no kernel")
    loss_cpu, g_cpu = loss_and_grads("cpu")
    err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
    scale = max(float(b.abs().max()) for b in g_cpu)
    log(f"# train card fp32 vs CPU fp32 (2 rows, 2 layers, attention dropout "
        f"{ATTN_RATE}): loss {loss_card!r} vs {loss_cpu!r}; trunk grads max_abs_err "
        f"{err!r} of max |grad| {scale!r} (limits: loss 1e-4 relative, grads 1e-3 of "
        f"max |grad|)")
    check(abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu), "card loss disagrees with the CPU")
    check(err <= 1e-3 * scale, "card gradients disagree with the CPU")


def _time_train_attention(label, B, S, masked, gen, backward) -> dict:
    """A training attention kernel vs plain at the step's shape, then both
    and the library call (SDPA without dropout, which cannot draw the
    hash mask) timed."""
    q, k, v, bias, keep, seed, do = _train_attn_inputs(B, S, BF16, gen, masked)
    H, D = q.shape[2], q.shape[3]
    io = B * S * H * D * 2   # one (B, S, H, D) bf16 tensor
    stats = B * H * S * 4    # lse (and, backward, delta is scratch: not counted)
    kb = B * S * 4 if masked else 0
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if keep is None else keep[:, None, None, :]
    if not backward:
        bound, by = _bound_ms(4.0 * B * H * S * S * D, 4 * io + stats + kb, BF16)
        fn = lambda: flash_attention_train_fwd(q, k, v, bias, seed, ATTN_RATE)  # noqa: E731
        plain = lambda: flash_attention_train_fwd_plain(q, k, v, bias, seed, ATTN_RATE)  # noqa: E731
        err = _compare(f"attention fwd bf16 {label}", fn()[0], plain()[0], BF16)
        lib = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    else:
        out, lse = flash_attention_train_fwd(q, k, v, bias, seed, ATTN_RATE)
        # the path's bias takes no gradient: no db
        bound, by = _bound_ms(10.0 * B * H * S * S * D, 8 * io + stats + kb, BF16)
        fn = lambda: flash_attention_train_bwd(  # noqa: E731
            q, k, v, bias, out, lse, do, seed, ATTN_RATE, need_db=False)
        plain = lambda: flash_attention_train_bwd_plain(  # noqa: E731
            q, k, v, bias, out, lse, do, seed, ATTN_RATE, need_db=False)
        err = max(_compare_rel(f"attention {n} bf16 {label}", g, w, BF16)
                  for n, g, w in zip(("dq", "dk", "dv"), fn()[:3], plain()[:3]))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            torch.autograd.grad(o, (qg, kg, vg), dot)
        lib = _time_ms(sdpa_fwd_bwd) - _time_ms(
            lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask))
    return dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
                bound_ms=bound, bound_by=by, library_ms=lib)


def _time_train_ffn(label, M, gen, backward) -> dict:
    """A training FFN kernel vs plain at the step's shape, then both timed
    (no single library call computes the fused function)."""
    x, w1, b1, w2, b2, g = _train_ffn_inputs(M, BF16, gen)
    H, I = w1.shape
    if not backward:
        bound, by = _bound_ms(4.0 * M * H * I, 2 * M * H * 2 + 2 * H * I * 2 + (H + I) * 4,
                              BF16)
        fn = lambda: fused_ffn_fwd(x, w1, b1, w2, b2)  # noqa: E731
        plain = lambda: fused_ffn_plain(x, w1, b1, w2, b2)  # noqa: E731
        err = _compare(f"ffn fwd bf16 {label}", fn(), plain(), BF16)
    else:
        # x, g, dx; dh and a; W1 and W2 in bf16; b1
        nbytes = 3 * M * H * 2 + 2 * M * I * 2 + 2 * H * I * 2 + I * 4
        bound, by = _bound_ms(6.0 * M * H * I, nbytes, BF16)
        fn = lambda: fused_ffn_bwd(x, g, w1, b1, w2)  # noqa: E731
        plain = lambda: fused_ffn_bwd_plain(x, g, w1, b1, w2)  # noqa: E731
        got, want = fn(), plain()
        err = max(_compare_rel(f"ffn dx bf16 {label}", got[0], want[0], BF16),
                  _compare_rel(f"ffn dh bf16 {label}", got[1], want[1], BF16),
                  _compare(f"ffn a bf16 {label}", got[2], want[2], BF16))
    return dict(max_abs_err=err, ms=_time_ms(fn), plain_ms=_time_ms(plain, iters=3),
                bound_ms=bound, bound_by=by, library_ms=None)


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
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    attn_cu = "stonkgs_tpu_torch/csrc/flash_attention_train.cu"
    ffn_cu = "stonkgs_tpu_torch/csrc/ffn_train.cu"
    sources = {"ffn_ln_block": ("stonkgs_tpu_torch/csrc/ffn_ln_block.cu",
                                "stonkgs_tpu/ops/fused_ffn.py:438"),
               "flash_attention_infer": ("stonkgs_tpu_torch/csrc/flash_attention_infer.cu",
                                         "stonkgs_tpu/ops/flash_attention.py:359"),
               "flash_attention_train_fwd": (attn_cu, "stonkgs_tpu/ops/flash_attention.py:92"),
               "flash_attention_train_bwd": (attn_cu, "stonkgs_tpu/ops/flash_attention.py:118"),
               "ffn_train_fwd": (ffn_cu, "stonkgs_tpu/ops/fused_ffn.py:54"),
               "ffn_train_bwd": (ffn_cu, "stonkgs_tpu/ops/fused_ffn.py:206")}
    kernels = []
    for name in sources:
        src, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        **times[name],
                        "max_abs_err": max(errs[name], times[name]["max_abs_err"])})
    log(f"# card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
