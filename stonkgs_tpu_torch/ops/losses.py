"""Losses of the pre-training path, with torch ``CrossEntropyLoss`` semantics.

The port of ``masked_cross_entropy`` and ``gather_masked_positions`` from
the JAX package's ``stonkgs_tpu/ops/losses.py``: the MLM and ELM losses
decode only the gathered masked positions instead of (B, S, vocab) logits.
"""

from __future__ import annotations

from typing import Tuple

import torch

IGNORE_INDEX = -100


def masked_cross_entropy(
    logits: torch.Tensor,   # (..., V)
    labels: torch.Tensor,   # (...,) int, IGNORE_INDEX to skip
) -> torch.Tensor:
    """Mean cross entropy in fp32 over positions where labels != -100.

    Matches ``torch.nn.CrossEntropyLoss(ignore_index=-100)`` (reduction
    ``mean``) except that an all-ignored batch yields 0 instead of NaN
    (``stonkgs_tpu/ops/losses.py:23-45``)."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).to(torch.int64)
    logits_f = logits.float()
    lse = torch.logsumexp(logits_f, dim=-1)
    target = torch.gather(logits_f, -1, safe[..., None])[..., 0]
    w = valid.float()
    return ((lse - target) * w).sum() / w.sum().clamp_min(1.0)


def gather_masked_positions(
    hidden: torch.Tensor,   # (B, S, H)
    labels: torch.Tensor,   # (B, S) with IGNORE_INDEX on unmasked positions
    max_predictions: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hidden states of the masked positions, masked ones first.

    Returns (gathered_hidden (B, K, H), gathered_labels (B, K), valid
    (B, K)), K = ``max_predictions``.  Among equal keys the lowest index
    comes first, as ``jax.lax.top_k`` orders them
    (``stonkgs_tpu/ops/losses.py:86-88``); ``torch.topk`` promises no
    order, so this is a stable descending sort.  Extra slots carry
    IGNORE_INDEX."""
    is_masked = labels != IGNORE_INDEX
    positions = torch.sort(is_masked.to(torch.int32), dim=1, descending=True,
                           stable=True).indices[:, :max_predictions]
    gathered = torch.gather(
        hidden, 1, positions[..., None].expand(-1, -1, hidden.shape[-1]))
    valid = torch.gather(is_masked, 1, positions)
    g_labels = torch.where(valid, torch.gather(labels, 1, positions), IGNORE_INDEX)
    return gathered, g_labels, valid
