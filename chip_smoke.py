"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: the card's name and power limit (nvidia-smi); CUDA must exist;
2. build: both CUDA kernels from ``stonkgs_tpu_torch/csrc`` with nvcc, in
   parallel, with ptxas's register and spill report;
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 and fp32, at the serving path's shapes;
4. serving: ``STonKGsEngine.embed`` at full BERT-base width (backbone and
   trunk, 256 + 256, KG vocabulary 100,000, random seeded weights) on 512
   rows, in parity mode and with ``length_buckets=(64, 128)``; checks the
   kernels' launch counts, finite output, the card in fp32 against the
   CPU in fp32, and the card in bf16 against the CPU in fp32;
5. timing: embed throughput, and each kernel's time at the path's shapes
   beside its bound, its plain version and (attention) PyTorch's SDPA.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from stonkgs_tpu_torch.ops.fused_ffn import fused_ffn_ln_block, fused_ffn_ln_block_plain
from stonkgs_tpu_torch.utils.convert import params_to

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
KERNELS = ("ffn_ln_block", "flash_attention_infer")
BATCH = 128
ROWS = 512
BUCKETS = (64, 128)


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
    _build.build_all(KERNELS)
    log(f"# build: {time.perf_counter() - t0:.1f} s for {len(KERNELS)} kernels "
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
    err = float((g - w).abs().max())
    tol = TOL[dtype]
    ok = bool(torch.allclose(g, w, **tol))
    log(f"# check {name}: max_abs_err {err!r} tol atol={tol['atol']} "
        f"rtol={tol['rtol']} {'ok' if ok else 'FAIL'}")
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


def _reset_counts() -> None:
    fused_ffn_ln_block.launches = 0
    flash_attention_infer.launches = 0


def _counts() -> dict:
    return {"ffn_ln_block": fused_ffn_ln_block.launches,
            "flash_attention_infer": flash_attention_infer.launches}


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
    _reset_counts()
    out = engine.embed(feats)
    counts = _counts()
    n_batches = math.ceil(ROWS / BATCH)
    per_batch = cfg.bert.num_hidden_layers * 2 - 1   # backbone 12 + trunk 11
    log(f"# launches parity embed ({n_batches} batches): {counts}")
    check(out.shape == (ROWS, cfg.bert.hidden_size), f"embed shape {out.shape}")
    check(bool(np.isfinite(out).all()), "embed output not finite")
    for name, c in counts.items():
        check(c == per_batch * n_batches,
              f"{name}: {c} launches, expected {per_batch} x {n_batches}")

    _reset_counts()
    out_b = bucketed.embed(feats)
    counts_b = _counts()
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
    return engine, bucketed, feats, counts


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


def main() -> int:
    try:
        card = phase_device()
        phase_build()
        errs = phase_kernels()
        cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=100_000)
        engine, bucketed, feats, counts = phase_serving(cfg)
        times = phase_timing(cfg, engine, bucketed, feats)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    sources = {"ffn_ln_block": ("stonkgs_tpu_torch/csrc/ffn_ln_block.cu",
                                "stonkgs_tpu/ops/fused_ffn.py:438"),
               "flash_attention_infer": ("stonkgs_tpu_torch/csrc/flash_attention_infer.cu",
                                         "stonkgs_tpu/ops/flash_attention.py:359")}
    kernels = []
    for name in KERNELS:
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
