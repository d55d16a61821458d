"""Prediction heads of the port: pre-training (ELM/MLM, NSP) and
sequence classification.

The port of the JAX package's ``stonkgs_tpu/models/heads.py``.  The ELM
head shares one BERT ``transform`` (dense + gelu + LayerNorm) and splits
the sequence between modality-specific bias-free decoders.  Quirk kept on
purpose: the reference creates ``text_bias`` / ``entity_bias`` parameters
but never applies them (``heads.py:6-10``); they stay in the tree and are
not added.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from stonkgs_tpu_torch.config import BertConfig
from stonkgs_tpu_torch.models.bert import (
    DropoutRng,
    _init_dense,
    _init_layer_norm,
    _trunc_normal,
    activation,
    dense,
    dropout,
    layer_norm,
)


def init_elm_head(
    gen: torch.Generator,
    cfg: BertConfig,
    segment_vocab_sizes: Sequence[int],
    segment_names: Sequence[str] = ("text", "entity"),
) -> dict:
    """ELM head: shared transform + one bias-free decoder per segment, drawn
    from ``gen``."""
    h, std = cfg.hidden_size, cfg.initializer_range
    p = {"transform": {"dense": _init_dense(gen, h, h, std),
                       "layer_norm": _init_layer_norm(h)}}
    for name, vs in zip(segment_names, segment_vocab_sizes):
        p[f"{name}_decoder"] = {"kernel": _trunc_normal(gen, (h, vs), std)}
        p[f"{name}_bias"] = torch.zeros(vs)   # kept, never applied
    return p


def elm_transform(p: dict, hidden: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """Shared BertPredictionHeadTransform: dense -> act -> LayerNorm."""
    x = activation(cfg.hidden_act)(dense(hidden, p["transform"]["dense"]))
    return layer_norm(x, p["transform"]["layer_norm"], cfg.layer_norm_eps)


def elm_decode_segment(p: dict, transformed: torch.Tensor, name: str) -> torch.Tensor:
    """Project transformed hidden states onto one segment's vocabulary,
    bias-free (the reference's quirk)."""
    return dense(transformed, p[f"{name}_decoder"])


def elm_head_dense(
    p: dict,
    hidden: torch.Tensor,              # (B, S, H)
    cfg: BertConfig,
    segment_bounds: Sequence[Tuple[int, int]],
    segment_names: Sequence[str],
) -> Tuple[torch.Tensor, ...]:
    """Dense (reference-shaped) head: full logits per segment slice."""
    t = elm_transform(p, hidden, cfg)
    return tuple(elm_decode_segment(p, t[:, a:b], name)
                 for (a, b), name in zip(segment_bounds, segment_names))


def init_nsp_head(gen: torch.Generator, cfg: BertConfig) -> dict:
    """Next-sentence head: linear hidden -> 2."""
    return _init_dense(gen, cfg.hidden_size, 2, cfg.initializer_range)


def nsp_head(p: dict, pooled: torch.Tensor) -> torch.Tensor:
    """NSP logits from the pooled output."""
    return dense(pooled, p)


def init_classifier_head(gen: torch.Generator, cfg: BertConfig,
                         num_labels: int) -> dict:
    """Linear (hidden -> num_labels) head, drawn from ``gen``."""
    return _init_dense(gen, cfg.hidden_size, num_labels, cfg.initializer_range)


def classifier_head(
    p: dict,
    pooled: torch.Tensor,
    *,
    dropout_prob: float = 0.0,
    rng: Optional[DropoutRng] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Dropout (training) + linear classification head over the pooled
    output."""
    return dense(dropout(pooled, dropout_prob, rng, deterministic), p)
