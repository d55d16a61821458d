"""The BigBird middle-block pair on one CUDA card, at the ProtSTonKGs paths' shapes.

Run from the root of a checkout::

    python -m stonkgs_tpu_torch.benchmarks.bench_bigbird_pair [--iters N]

For each shape (the trunk at S=4096, 12 heads of 64, r=3 with blocks of
64 and 128, as served at B=8 with the all-zero eval plan and trained at
B=2 with HF's training plan; the configurations ``run_pretraining``
derives from 128- and 32-wide KG TSVs: 4 heads of 32 or 2 of 16, block
512, r=1; and the 128-wide one at S=768, block 96), in bf16, it prints
one JSON line with the time of ``bigbird_mid_fwd`` or
``bigbird_mid_bwd`` (CUDA events over ``--iters`` calls) and the card's
name and power limit.  A shape the checkout's kernels refuse prints a
line with ``"refused"`` instead.  Inputs come from a seeded generator.

It uses only the wrappers' public signatures, so it also times an older
checkout of the port when copied into it: run it in two checkouts in
turn within one job on the card (parent, change, change, parent) to
compare them.
"""

from __future__ import annotations

import argparse

import torch

from stonkgs_tpu_torch.benchmarks._util import emit, require_cuda, time_ms
from stonkgs_tpu_torch.ops.bigbird_sparse import (
    bigbird_mid_bwd,
    bigbird_mid_fwd,
    build_rand_attn,
)

BF16 = torch.bfloat16
# (label, S, H, D, block size, r)
GEOMETRIES = (
    ("trunk bs=64", 4096, 12, 64, 64, 3),
    ("trunk bs=128", 4096, 12, 64, 128, 3),
    ("128-wide TSV", 4096, 4, 32, 512, 1),
    ("32-wide TSV", 4096, 2, 16, 512, 1),
    ("128-wide TSV S=768", 768, 4, 32, 96, 1),
)
# (what, B, backward, plan)
CALLS = (("fwd B=8 eval", 8, False, "eval"), ("fwd B=2 train", 2, False, "train"),
         ("bwd B=2 train", 2, True, "train"))


def _inputs(B, S, H, D, bs, r, plan, gen):
    """q, k, v (B, S, H, D) bf16, an all-ones mask, the plan, dO."""
    def n(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", BF16)
    nb = S // bs
    q, k, v = n(B, S, H, D), n(B, S, H, D), n(B, S, H, D)
    if plan == "eval":
        rand = torch.zeros(H, nb - 2, r, dtype=torch.int32)
    else:
        rand = torch.as_tensor(build_rand_attn(S, bs, r, H, 1, S, training=True)[0])
    mask = torch.ones(B, S, device="cuda")
    return q, k, v, mask, rand.cuda(), n(B, (nb - 2) * bs, H, D)


def bench(label, S, H, D, bs, r, what, B, backward, plan, gen, card, iters) -> dict:
    name = f"bigbird_mid_{'bwd' if backward else 'fwd'} {label} {what}"
    shape = dict(S=S, H=H, D=D, block_size=bs, r=r, B=B, plan=plan, card=card)
    q, k, v, mask, rand, dout = _inputs(B, S, H, D, bs, r, plan, gen)
    try:
        out, lse = bigbird_mid_fwd(q, k, v, mask, rand, bs)
    except (RuntimeError, ValueError) as e:
        return emit(name, float("nan"), "ms", refused=str(e)[:200], **shape)
    if backward:
        fn = lambda: bigbird_mid_bwd(q, k, v, mask, rand, bs, out, lse, dout)  # noqa: E731
    else:
        fn = lambda: bigbird_mid_fwd(q, k, v, mask, rand, bs)  # noqa: E731
    return emit(name, time_ms(fn, iters=iters, warmup=5), "ms", **shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50, help="calls timed a shape")
    args = ap.parse_args(argv)
    card = require_cuda()
    gen = torch.Generator().manual_seed(18)
    for geometry in GEOMETRIES:
        for call in CALLS:
            bench(*geometry, *call, gen, card, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
