"""The training FFN pair on one CUDA card, at the pre-training paths' shapes.

Run from the root of a checkout::

    python -m stonkgs_tpu_torch.benchmarks.bench_ffn_train [--trace]

For each shape that a pre-training step gives ``fused_ffn_fwd`` and
``fused_ffn_bwd`` (the STonKGs trunk and backbone at B=32; in a
ProtSTonKGs step at B=2 the frozen ProtBERT and BioBERT and the BigBird
trunk with ``gelu_new``), in bf16, it prints one JSON line: the kernel's
time, its bound (the larger of its products at 989 TFLOP/s and its
bytes, each input read once and each output written once, at 3.35
TB/s), its plain version's time, and the time of the cuBLAS bf16
products the function contains, each timed alone (x W1 + h W2 forward,
x W1 + g W2^T + dh W1^T backward), a yardstick only: no one PyTorch call
computes the fused function.  ``--trace`` adds the device time of every
kernel that one call launches (``torch.profiler``).  Inputs come from a
seeded generator; each line carries the card's name and power limit.

It uses only the wrappers' public signatures, so it also times an older
checkout of the port when copied into it.
"""

from __future__ import annotations

import argparse

import torch

from stonkgs_tpu_torch.benchmarks._util import emit, require_cuda, time_ms
from stonkgs_tpu_torch.ops.fused_ffn import (
    fused_ffn_bwd,
    fused_ffn_bwd_plain,
    fused_ffn_fwd,
    fused_ffn_plain,
)

BF16 = torch.bfloat16
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
# (label, M, H, I, act, backward, launches per step)
SHAPES = (
    ("STonKGs trunk", 16384, 768, 3072, "gelu", False, 12),
    ("STonKGs trunk", 16384, 768, 3072, "gelu", True, 12),
    ("STonKGs backbone", 8192, 768, 3072, "gelu", False, 12),
    ("ProtBERT", 6144, 1024, 4096, "gelu", False, 30),
    ("BigBird trunk", 8192, 768, 3072, "gelu_new", False, 12),
    ("BigBird trunk", 8192, 768, 3072, "gelu_new", True, 12),
    ("BioBERT", 1536, 768, 3072, "gelu", False, 12),
)


def _inputs(M, H, I, gen):
    """x and g (M, H) in bf16; fp32 weights and biases, as the model's."""
    def n(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen)).cuda()
    return (n(M, H).to(BF16), n(H, I, std=0.02), n(I, std=0.02), n(I, H, std=0.02),
            n(H, std=0.02), n(M, H).to(BF16))


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


def bench(label, M, H, I, act, backward, launches, gen, card, trace=False) -> dict:
    x, w1, b1, w2, b2, g = _inputs(M, H, I, gen)
    w1b, w2b = w1.to(BF16), w2.to(BF16)
    if backward:
        flops = 6.0 * M * H * I
        # x, g, dx; dh and a; W1 and W2; b1
        nbytes = 3 * M * H * 2 + 2 * M * I * 2 + 2 * H * I * 2 + I * 4
        fn = lambda: fused_ffn_bwd(x, g, w1, b1, w2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_bwd_plain(x, g, w1, b1, w2, act=act)  # noqa: E731
        dh = fn()[1]
        gemms = {"x W1": lambda: x @ w1b, "g W2^T": lambda: g @ w2b.T,
                 "dh W1^T": lambda: dh @ w1b.T}
    else:
        flops = 4.0 * M * H * I
        nbytes = 2 * M * H * 2 + 2 * H * I * 2 + (H + I) * 4
        fn = lambda: fused_ffn_fwd(x, w1, b1, w2, b2, act=act)  # noqa: E731
        plain = lambda: fused_ffn_plain(x, w1, b1, w2, b2, act=act)  # noqa: E731
        h = x @ w1b
        gemms = {"x W1": lambda: x @ w1b, "h W2": lambda: h @ w2b}
    ms = time_ms(fn)
    bound = max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S) * 1e3
    cublas = {name: time_ms(f) for name, f in gemms.items()}
    extra = {"device_ms_by_kernel": _device_ms_by_kernel(fn)} if trace else {}
    return emit(f"ffn_train_{'bwd' if backward else 'fwd'} {label} M={M} H={H} {act}", ms, "ms",
                launches_per_step=launches, bound_ms=bound,
                bound_by="operations" if flops / PEAK_BF16 >= nbytes / HBM_BYTES_PER_S
                else "bytes",
                tflops=flops / (ms * 1e-3) / 1e12, plain_ms=time_ms(plain, iters=3),
                cublas_gemms_ms=sum(cublas.values()), cublas_ms_by_product=cublas, card=card,
                **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="add each kernel's device time (torch.profiler)")
    args = ap.parse_args(argv)
    card = require_cuda()
    gen = torch.Generator().manual_seed(4)
    for shape in SHAPES:
        bench(*shape, gen, card, trace=args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
