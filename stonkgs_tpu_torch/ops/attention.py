"""Multi-head attention of the port.

``dot_product_attention`` runs every full-sequence attention through the
port's kernels (on a CPU tensor, through their plain versions):

* inference (``deterministic=True``):
  :func:`stonkgs_tpu_torch.ops.flash_attention.flash_attention_infer`;
* training: :func:`stonkgs_tpu_torch.ops.flash_attention.flash_attention_train`
  with the layer's dropout rate and the call's two-word seed, as the JAX
  package's flash path does (``stonkgs_tpu/ops/attention.py:98-121``).
  Under a mesh each rank runs the kernel on its own rows; the seed comes
  from the step's :class:`~stonkgs_tpu_torch.models.bert.DropoutRng`, which
  :func:`stonkgs_tpu_torch.train.pretraining.step_rng` folds with the data
  index (the counterpart of ``_sharded_flash``, ``attention.py:51-80``), so
  ranks of one data index draw the same masks and data shards differ.

Unlike the JAX package, which sends S < 384 to XLA on a TPU
(``stonkgs_tpu/ops/attention.py:34``), the port takes the kernels at every
S: that routing was measured on a TPU and says nothing about the H100.

``plain_attention`` is the counterpart of the JAX package's
``_xla_attention``: the einsum form that the single-query ``cls_only``
layer keeps, with the same rounding points.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stonkgs_tpu_torch.ops.flash_attention import flash_attention_infer, flash_attention_train


def dot_product_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B, 1, 1, S) additive key bias
    *,
    deterministic: bool = True,
    dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,  # two int32 words (training)
) -> torch.Tensor:
    """Scaled dot-product attention. Returns (B, S, H, D).

    Training applies the hash dropout at ``dropout_rate`` when ``seed`` is
    given (no seed: no dropout, as the JAX package without an rng)."""
    if deterministic:
        return flash_attention_infer(q, k, v, bias)
    return flash_attention_train(q, k, v, bias, dropout_rate=dropout_rate, seed=seed)


def plain_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, H, D)
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Sq, Sk)
) -> torch.Tensor:
    """Einsum attention in the input dtype, softmax in fp32 (the JAX
    package's ``_xla_attention``, deterministic)."""
    # the scale rounded to the input dtype first, as the JAX package does
    scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype))
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
