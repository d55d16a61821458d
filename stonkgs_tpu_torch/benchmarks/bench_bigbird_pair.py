"""The BigBird middle-block pair on one CUDA card, at the ProtSTonKGs paths' shapes.

Run from the root of a checkout::

    python -m stonkgs_tpu_torch.benchmarks.bench_bigbird_pair [--iters N] [--widths] [--full]

For each shape (the trunk at S=4096, 12 heads of 64, r=3 with blocks of
64 and 128, as served at B=8 with the all-zero eval plan and trained at
B=2 with HF's training plan, and at 12 heads of 32; the configurations ``run_pretraining``
derives from 128- and 32-wide KG TSVs: 4 heads of 32 or 2 of 16, block
512, r=1; and the 128-wide one at S=768, block 96), in bf16, it prints
one JSON line with the time of ``bigbird_mid_fwd`` or
``bigbird_mid_bwd`` (CUDA events over ``--iters`` calls) and the card's
name and power limit.  ``--widths`` adds the configurations derived from
48-, 80- and 144-wide KG TSVs (2 heads of 24 and 40, 4 of 36; blocks 512
and 96), the head widths 8, 48 and 56 at the 128-wide shape, and the
trunk's 768 in 6 heads of 128 (S=4096, block 64, r=3: the bf16 pair
past D = 64); ``--full``
adds to each line the bound (the products at 989 TFLOP/s or the bytes,
each input read once and each output written once, at 3.35 TB/s), the
plain version's time and the library call's: SDPA over operands gathered
beforehand (``benchmarks/bigbird_sdpa.py``; the backward: its own alone
over a saved forward).  A shape the checkout's kernels refuse prints a
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
    bigbird_mid_bwd_plain,
    bigbird_mid_fwd,
    bigbird_mid_fwd_plain,
    build_rand_attn,
)

BF16 = torch.bfloat16
# (label, S, H, D, block size, r)
GEOMETRIES = (
    ("trunk bs=64", 4096, 12, 64, 64, 3),
    ("trunk bs=128", 4096, 12, 64, 128, 3),
    ("trunk D=32 bs=64", 4096, 12, 32, 64, 3),
    ("trunk D=32 bs=128", 4096, 12, 32, 128, 3),
    ("128-wide TSV", 4096, 4, 32, 512, 1),
    ("32-wide TSV", 4096, 2, 16, 512, 1),
    ("128-wide TSV S=768", 768, 4, 32, 96, 1),
)
# --widths: the configurations derived from 48-, 80- and 144-wide TSVs,
# head widths 8, 48 and 56 at the 128-wide TSV's shape, and the trunk in 6
# heads of 128
WIDTH_GEOMETRIES = (
    ("48-wide TSV", 4096, 2, 24, 512, 1),
    ("80-wide TSV", 4096, 2, 40, 512, 1),
    ("144-wide TSV", 4096, 4, 36, 512, 1),
    ("144-wide TSV S=768", 768, 4, 36, 96, 1),
    ("D=8 at the 128-wide shape", 4096, 4, 8, 512, 1),
    ("D=48 at the 128-wide shape", 4096, 4, 48, 512, 1),
    ("D=56 at the 128-wide shape", 4096, 4, 56, 512, 1),
    ("trunk 6x128", 4096, 6, 128, 64, 3),
)
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
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


def _bound_ms(S, H, D, bs, r, B, backward) -> tuple:
    """(bound ms, what bounds it): the forward's two products a score,
    q's middle rows, k, v and the mask read, out and lse written; the
    backward's five products a score, q, o, dO middle rows, k, v, lse and
    the mask read, dq (middle rows), dk and dv written."""
    nb = S // bs
    n_mid, W = nb - 2, (5 + r) * bs
    tensor, mid = B * S * H * D * 2, B * n_mid * bs * H * D * 2
    small = B * H * n_mid * bs * 4 + B * S * 4
    products = 2.0 * B * H * n_mid * bs * W * D
    flops, nbytes = ((5 * products, 4 * mid + 4 * tensor + small) if backward
                     else (2 * products, 2 * mid + 2 * tensor + small))
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _library_ms(q, k, v, mask, rand, bs, backward, gen, iters) -> float:
    """SDPA over the gathered operands (the forward), or its backward
    alone over a saved forward."""
    from stonkgs_tpu_torch.benchmarks.bigbird_sdpa import gathered_operands, sdpa_mid

    qg, kg, vg, bias = gathered_operands(q, k, v, mask, rand, bs)
    if not backward:
        return time_ms(lambda: sdpa_mid(qg, kg, vg, bias), iters=iters, warmup=5)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qg, kg, vg))
    o = sdpa_mid(qg, kg, vg, bias)
    do = torch.randn(o.shape, generator=gen).to("cuda", o.dtype)
    return time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True),
                   iters=iters, warmup=5)


def bench(label, S, H, D, bs, r, what, B, backward, plan, gen, card, iters,
          full=False) -> dict:
    name = f"bigbird_mid_{'bwd' if backward else 'fwd'} {label} {what}"
    shape = dict(S=S, H=H, D=D, block_size=bs, r=r, B=B, plan=plan, card=card)
    q, k, v, mask, rand, dout = _inputs(B, S, H, D, bs, r, plan, gen)
    try:
        out, lse = bigbird_mid_fwd(q, k, v, mask, rand, bs)
    except (RuntimeError, ValueError) as e:
        return emit(name, float("nan"), "ms", refused=str(e)[:200], **shape)
    if backward:
        fn = lambda: bigbird_mid_bwd(q, k, v, mask, rand, bs, out, lse, dout)  # noqa: E731
        plain = lambda: bigbird_mid_bwd_plain(q, k, v, mask, rand, bs, out, lse,  # noqa: E731
                                              dout)
    else:
        fn = lambda: bigbird_mid_fwd(q, k, v, mask, rand, bs)  # noqa: E731
        plain = lambda: bigbird_mid_fwd_plain(q, k, v, mask, rand, bs)  # noqa: E731
    ms = time_ms(fn, iters=iters, warmup=5)
    extra = {}
    if full:
        bound, by = _bound_ms(S, H, D, bs, r, B, backward)
        extra = dict(bound_ms=bound, bound_by=by, plain_ms=time_ms(plain, iters=3),
                     library_ms=_library_ms(q, k, v, mask, rand, bs, backward, gen, iters))
    return emit(name, ms, "ms", **extra, **shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50, help="calls timed a shape")
    ap.add_argument("--widths", action="store_true",
                    help="add the head widths the command line derives from 48- to 144-wide TSVs")
    ap.add_argument("--full", action="store_true",
                    help="add the bound, the plain version's and SDPA's times")
    args = ap.parse_args(argv)
    card = require_cuda()
    gen = torch.Generator().manual_seed(18)
    for geometry in GEOMETRIES + (WIDTH_GEOMETRIES if args.widths else ()):
        for call in CALLS:
            bench(*geometry, *call, gen, card, args.iters, full=args.full)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
