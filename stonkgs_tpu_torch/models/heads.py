"""Prediction heads of the port: the sequence-classification head.

The port of ``classifier_head`` and its init from the JAX package's
``stonkgs_tpu/models/heads.py``; the pre-training heads wait for the
training slice.
"""

from __future__ import annotations

import torch

from stonkgs_tpu_torch.config import BertConfig
from stonkgs_tpu_torch.models.bert import _init_dense, dense


def init_classifier_head(gen: torch.Generator, cfg: BertConfig,
                         num_labels: int) -> dict:
    """Linear (hidden -> num_labels) head, drawn from ``gen``."""
    return _init_dense(gen, cfg.hidden_size, num_labels, cfg.initializer_range)


def classifier_head(p: dict, pooled: torch.Tensor) -> torch.Tensor:
    """Linear classification head over the pooled output (its dropout, the
    training half, is not ported yet)."""
    return dense(pooled, p)
