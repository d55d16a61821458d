"""One PyTorch call that computes the BigBird middle query blocks: the
library yardstick beside the kernel pair of ``ops/bigbird_sparse.py``.

``scaled_dot_product_attention`` over operands gathered beforehand: each
middle query block of each (batch, head) is one batch entry of 64 query
rows, its (5 + r) · 64 slot keys and values gathered into (N, 1, W, D)
tensors, and the slot penalties (the mask's and the duplicate window
slot's -10000) as a float mask; 4-D, one head a batch entry, as the
fused SDPA backends take them.  Repeated blocks (the all-zero eval
plan) are separate keys there, as in the kernels, which a mask over the
(B, S) keys cannot express.  The gather is not part of the call, as a
library GEMM is timed on operands made beforehand.  The port never calls
this: ``chip_smoke.py`` times it beside the kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stonkgs_tpu_torch.ops.bigbird_sparse import _mid_operands


def gathered_operands(q, k, v, mask, rand_attn, block_size):
    """q, k, v (B, S, H, D), mask (B, S), rand_attn (H, nb-2, r) ->
    (qg (N, 1, bs, D), kg (N, 1, W, D), vg (N, 1, W, D), bias (N, 1, 1, W))
    with N = B·H·(nb-2) and W = (5+r)·bs, contiguous; the bias in q's
    dtype."""
    qm, kc, vc, pen, _ = _mid_operands(q, k, v, mask, rand_attn, block_size)
    B, H, n, bs, D = qm.shape
    N = B * H * n
    return (qm.reshape(N, 1, bs, D), kc.reshape(N, 1, -1, D), vc.reshape(N, 1, -1, D),
            pen.reshape(N, 1, 1, -1).to(q.dtype))


def sdpa_mid(qg, kg, vg, bias):
    """The one call: (N, 1, bs, D) context, softmax scale 1/√D."""
    return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)


def to_ctx(o: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """(N, 1, bs, D) -> the kernels' ctx layout (B, (nb-2)·bs, H, D)."""
    N, _, bs, D = o.shape
    n = N // (B * H)
    return o.reshape(B, H, n, bs, D).permute(0, 2, 3, 1, 4).reshape(B, n * bs, H, D)
