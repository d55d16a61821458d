"""The three attention kernels on one CUDA card, at the STonKGs paths' shapes.

Run from the root of a checkout::

    python -m stonkgs_tpu_torch.benchmarks.bench_attention [--iters N]

For each head split of a model the port runs (BERT-base's 12 heads of
64, MiniLM-L12-H384's 12 of 32, BERT-base's widths in 6 heads of 128, 3
of 256, 2 of 384 and one of 768, and the configs the command line
derives from 96-, 160-, 288- and 544-wide KG TSVs: 2 heads of 48 and 80,
4 of 72, 8 of 68), in bf16, it
prints one JSON line for each call of the paths: ``flash_attention_infer``
at B=128 over the trunk (S=512, key bias) and the backbone (S=256, no
bias), ``flash_attention_train_fwd`` at B=32 over both with the hash
dropout at 0.1, and ``flash_attention_train_bwd`` at B=32 over the trunk:
its time (CUDA events over ``--iters`` calls) and the card's name and
power limit.  A shape the checkout's kernels refuse prints a line with
``"refused"`` instead.  Inputs come from a seeded generator.

It uses only the wrappers' public signatures, so it also times an older
checkout of the port when copied into it: run it in two checkouts in
turn within one job on the card (parent, change, change, parent) to
compare them.
"""

from __future__ import annotations

import argparse

import torch

from stonkgs_tpu_torch.benchmarks._util import emit, require_cuda, time_ms
from stonkgs_tpu_torch.ops.flash_attention import (
    flash_attention_infer,
    flash_attention_train_bwd,
    flash_attention_train_fwd,
)

BF16 = torch.bfloat16
RATE = 0.1
# (label, heads, head width)
SPLITS = (
    ("BERT-base 12x64", 12, 64),
    ("MiniLM 12x32", 12, 32),
    ("BERT-base 6x128", 6, 128),
    ("BERT-base 3x256", 3, 256),
    ("BERT-base 2x384", 2, 384),
    ("1x768", 1, 768),
    ("CLI 96-wide 2x48", 2, 48),
    ("CLI 160-wide 2x80", 2, 80),
    ("CLI 288-wide 4x72", 4, 72),
    ("CLI 544-wide 8x68", 8, 68),
)
# (kernel, what, B, S, key bias)
CALLS = (("infer", "trunk", 128, 512, True), ("infer", "backbone", 128, 256, False),
         ("train_fwd", "trunk", 32, 512, True), ("train_fwd", "backbone", 32, 256, False),
         ("train_bwd", "trunk", 32, 512, True))


def _inputs(B, S, H, D, masked, gen):
    """q, k, v, dO (B, S, H, D) bf16, a (B, 1, 1, S) key bias of random
    right padding (or None), a two-word seed."""
    def n():
        return torch.randn(B, S, H, D, generator=gen).to("cuda", BF16)
    q, k, v, dout = n(), n(), n(), n()
    bias = None
    if masked:
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        keep = torch.arange(S)[None, :] < lengths[:, None]
        bias = ((1.0 - keep.float()) * -1e9)[:, None, None, :].cuda()
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32, generator=gen)
    return q, k, v, dout, bias, seed


def bench(label, H, D, kernel, what, B, S, masked, gen, card, iters) -> dict:
    name = f"flash_attention_{kernel} {label} {what}"
    shape = dict(B=B, S=S, H=H, D=D, key_bias=masked, card=card)
    q, k, v, dout, bias, seed = _inputs(B, S, H, D, masked, gen)
    try:
        out, lse = flash_attention_train_fwd(q, k, v, bias, seed, RATE)
    except (RuntimeError, ValueError) as e:
        return emit(name, float("nan"), "ms", refused=str(e)[:200], **shape)
    if kernel == "infer":
        fn = lambda: flash_attention_infer(q, k, v, bias)  # noqa: E731
    elif kernel == "train_fwd":
        fn = lambda: flash_attention_train_fwd(q, k, v, bias, seed, RATE)  # noqa: E731
    else:
        fn = lambda: flash_attention_train_bwd(  # noqa: E731
            q, k, v, bias, out, lse, dout, seed, RATE, need_db=False)
    return emit(name, time_ms(fn, iters=iters, warmup=5), "ms", **shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50, help="calls timed a shape")
    args = ap.parse_args(argv)
    card = require_cuda()
    gen = torch.Generator().manual_seed(19)
    for split in SPLITS:
        for call in CALLS:
            bench(*split, *call, gen, card, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
