"""The FFN kernels on one CUDA card, at the paths' shapes and at the widths the command line derives.

Run from the root of a checkout::

    python -m stonkgs_tpu_torch.benchmarks.bench_ffn_train [--set NAME ...] [--trace]

Sets of shapes (``--set``, default ``training``; ``all`` runs every set):

* ``training``: each shape that a pre-training step gives
  ``fused_ffn_fwd`` and ``fused_ffn_bwd`` (the STonKGs trunk and backbone
  at B=32; in a ProtSTonKGs step at B=2 the frozen ProtBERT and BioBERT
  and the BigBird trunk with ``gelu_new``), in bf16;
* ``serving``: ``fused_ffn_ln_block`` at the STonKGs trunk's serving
  shape (B=128, S=512) and ProtBERT's (B=8, S=3072), in bf16;
* ``fp32``: the three kernels in fp32 (the SIMT bodies that hold the
  model against the CPU) at MiniLM-L12-H384's H=384 and BERT-base's
  H=768, 16,384 rows;
* ``widths``: the three kernels in bf16 at the hidden widths the command
  line derives from KG TSVs that are no multiple of 32 or wider than
  1024 (48, 100, 112, 144, 1056, 1280, 2048; I = 4H), 16,384 rows.

For each shape it prints one JSON line: the kernel's time, its bound (the
larger of its products at the dtype's peak, 989 TFLOP/s in bf16 and 67
in fp32, and its bytes, each input read once and each output written
once, at 3.35 TB/s), its plain version's time, and the time of the
cuBLAS products the function contains, each timed alone (x W1 + h W2
forward and serving, x W1 + g W2^T + dh W1^T backward), a yardstick only:
no one PyTorch call computes the fused function.  ``--trace`` adds the
device time of every kernel that one call launches (``torch.profiler``).
A shape the checkout's kernels refuse prints a line with ``"refused"``
instead.  Inputs come from a seeded generator; each line carries the
card's name and power limit.

It uses only the wrappers' public signatures, so it also times an older
checkout of the port when copied into it: run it in two checkouts in turn
within one job on the card (parent, change, change, parent) to compare
them.
"""

from __future__ import annotations

import argparse

import torch

from stonkgs_tpu_torch.benchmarks._util import emit, require_cuda, time_ms
from stonkgs_tpu_torch.ops.fused_ffn import (
    fused_ffn_bwd,
    fused_ffn_bwd_plain,
    fused_ffn_fwd,
    fused_ffn_ln_block,
    fused_ffn_ln_block_plain,
    fused_ffn_plain,
)

BF16, F32 = torch.bfloat16, torch.float32
PEAK = {BF16: 989e12, F32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# (label, M, H, I, act, kind, launches per step or batch); kind "fwd" and
# "bwd": the training pair, "ln": the serving block
TRAINING = (
    ("STonKGs trunk", 16384, 768, 3072, "gelu", "fwd", 12),
    ("STonKGs trunk", 16384, 768, 3072, "gelu", "bwd", 12),
    ("STonKGs backbone", 8192, 768, 3072, "gelu", "fwd", 12),
    ("ProtBERT", 6144, 1024, 4096, "gelu", "fwd", 30),
    ("BigBird trunk", 8192, 768, 3072, "gelu_new", "fwd", 12),
    ("BigBird trunk", 8192, 768, 3072, "gelu_new", "bwd", 12),
    ("BioBERT", 1536, 768, 3072, "gelu", "fwd", 12),
)
SERVING = (
    ("STonKGs trunk", 65536, 768, 3072, "gelu", "ln", 12),
    ("ProtBERT", 24576, 1024, 4096, "gelu", "ln", 30),
)
FP32 = tuple((label, 16384, H, 4 * H, "gelu", kind, 2)
             for label, H in (("MiniLM", 384), ("STonKGs trunk", 768))
             for kind in ("ln", "fwd", "bwd"))
WIDTHS = tuple((f"CLI {H}-wide", 16384, H, 4 * H, "gelu", kind, 2)
               for H in (48, 100, 112, 144, 1056, 1280, 2048) for kind in ("ln", "fwd", "bwd"))
SETS = {"training": (TRAINING, BF16), "serving": (SERVING, BF16), "fp32": (FP32, F32),
        "widths": (WIDTHS, BF16)}


def _inputs(M, H, I, dtype, gen):
    """x, attention output and g (M, H) in ``dtype``; fp32 weights,
    biases and LayerNorm vectors, as the model's."""
    def n(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen)).cuda()
    return dict(x=n(M, H).to(dtype), attn=n(M, H).to(dtype), g=n(M, H).to(dtype),
                w1=n(H, I, std=0.02), b1=n(I, std=0.02), w2=n(I, H, std=0.02),
                b2=n(H, std=0.02), s1=n(H, std=0.1, mean=1.0), e1=n(H, std=0.1),
                s2=n(H, std=0.1, mean=1.0), e2=n(H, std=0.1))


def _device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """{kernel name: device ms a call} over ``calls`` traced calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:120]: e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
            if e.device_type.name == "CUDA"}


def bench(label, M, H, I, act, kind, launches, dtype, gen, card, trace=False) -> dict:
    t = _inputs(M, H, I, dtype, gen)
    x, g, w1, b1, w2, b2 = t["x"], t["g"], t["w1"], t["b1"], t["w2"], t["b2"]
    w1c, w2c = w1.to(dtype), w2.to(dtype)
    size = 2 if dtype == BF16 else 4
    if kind == "bwd":
        flops = 6.0 * M * H * I
        # x, g, dx; dh and a; W1 and W2; b1
        nbytes = (3 * M * H + 2 * M * I + 2 * H * I) * size + I * 4
        fn = lambda: fused_ffn_bwd(x, g, w1, b1, w2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)  # noqa: E731
    elif kind == "fwd":
        flops = 4.0 * M * H * I
        nbytes = (2 * M * H + 2 * H * I) * size + (H + I) * 4
        fn = lambda: fused_ffn_fwd(x, w1, b1, w2, b2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_plain(x, w1, b1, w2, b2, act=act)  # noqa: E731
    else:
        flops = 4.0 * M * H * I
        # x, attn, out; both weights; b1, b2 and the LayerNorm vectors
        nbytes = (3 * M * H + 2 * H * I) * size + (5 * H + I) * 4
        args = (x, t["attn"], t["s1"], t["e1"], w1, b1, w2, b2, t["s2"], t["e2"])
        fn = lambda: fused_ffn_ln_block(*args, act=act)  # noqa: E731
        plain = lambda: fused_ffn_ln_block_plain(*args, act=act)  # noqa: E731
    name = {"fwd": "ffn_train_fwd", "bwd": "ffn_train_bwd", "ln": "ffn_ln_block"}[kind]
    name = f"{name} {label} M={M} H={H} I={I} {act} {'bf16' if dtype == BF16 else 'fp32'}"
    try:
        out = fn()
    except (RuntimeError, ValueError) as e:
        return emit(name, float("nan"), "ms", refused=str(e)[:200], card=card)
    if kind == "bwd":
        dh = out[1]
        gemms = {"x W1": lambda: x @ w1c, "g W2^T": lambda: g @ w2c.T,
                 "dh W1^T": lambda: dh @ w1c.T}
    else:
        h = x @ w1c
        gemms = {"x W1": lambda: x @ w1c, "h W2": lambda: h @ w2c}
    ms = time_ms(fn, iters=20 if dtype == BF16 else 5)
    bound = max(flops / PEAK[dtype], nbytes / HBM_BYTES_PER_S) * 1e3
    cublas = {n: time_ms(f, iters=20 if dtype == BF16 else 5) for n, f in gemms.items()}
    extra = {"device_ms_by_kernel": _device_ms_by_kernel(fn)} if trace else {}
    return emit(name, ms, "ms", launches_per_step=launches, bound_ms=bound,
                bound_by="operations" if flops / PEAK[dtype] >= nbytes / HBM_BYTES_PER_S
                else "bytes",
                tflops=flops / (ms * 1e-3) / 1e12, plain_ms=time_ms(plain, iters=3),
                cublas_gemms_ms=sum(cublas.values()), cublas_ms_by_product=cublas, card=card,
                **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", nargs="+", default=["training"], choices=[*SETS, "all"],
                    help="the sets of shapes to time")
    ap.add_argument("--trace", action="store_true",
                    help="add each kernel's device time (torch.profiler)")
    args = ap.parse_args(argv)
    card = require_cuda()
    gen = torch.Generator().manual_seed(4)
    for name in (list(SETS) if "all" in args.set else args.set):
        shapes, dtype = SETS[name]
        for shape in shapes:
            bench(*shape, dtype, gen, card, trace=args.trace)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
