"""Losses, with torch ``CrossEntropyLoss`` semantics.

The port of the JAX package's ``stonkgs_tpu/ops/losses.py``: the masked
cross entropy of pre-training and classification (the MLM and ELM losses
decode only the gathered masked positions instead of (B, S, vocab)
logits), the class-weighted cross entropy of the KG baseline, and MSE and
BCE-with-logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stonkgs_tpu_torch.parallel.mesh import data_sum

IGNORE_INDEX = -100


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] in fp32 (labels already in range)."""
    logits_f = logits.float()
    lse = torch.logsumexp(logits_f, dim=-1)
    return lse - torch.gather(logits_f, -1, labels.to(torch.int64)[..., None])[..., 0]


def masked_cross_entropy(
    logits: torch.Tensor,   # (..., V)
    labels: torch.Tensor,   # (...,) int, IGNORE_INDEX to skip
    *,
    label_weights: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Mean cross entropy in fp32 over positions where labels != -100,
    each position weighted by ``label_weights`` where given.

    Matches ``torch.nn.CrossEntropyLoss(ignore_index=-100)`` (reduction
    ``mean``) except that an all-ignored batch yields 0 instead of NaN
    (``stonkgs_tpu/ops/losses.py:23-45``).  Under a ``mesh`` with a data
    axis the rows are one data rank's share: the sum divides by the count
    over every data rank, so the ranks' losses add up to the global mean."""
    valid = labels != IGNORE_INDEX
    w = valid.float()
    if label_weights is not None:
        w = w * label_weights
    nll = _nll(logits, torch.where(valid, labels, 0))
    return (nll * w).sum() / data_sum(w.sum(), mesh).clamp_min(1.0)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss(weight=class_weights)``:
    sum(w_y · nll) / sum(w_y), the KG baseline's loss
    (``stonkgs_tpu/ops/losses.py:48-60``)."""
    w = class_weights[labels]
    return (_nll(logits, labels) * w).sum() / w.sum().clamp_min(1e-9)


def mse_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared error in fp32."""
    return (preds.float() - targets.float()).square().mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``torch.nn.BCEWithLogitsLoss`` (mean reduction) in fp32, in the JAX
    package's stable form max(z, 0) - z·t + log1p(exp(-|z|))."""
    z, t = logits.float(), targets.float()
    return (z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()


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
