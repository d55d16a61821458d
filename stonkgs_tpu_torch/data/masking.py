"""Vectorized BERT-style masking and NSP negative sampling.

The port's copy of the JAX package's ``data/masking.py``: the numpy half
gives the same arrays on the same ``np.random.Generator`` state;
:func:`mask_tokens_torch`, the counterpart of ``mask_tokens_jax``, masks on
the tensors' device with a ``torch.Generator`` (the same distribution,
not the same draws as ``jax.random``).  Behaviour, from the reference's
``replace_mlm_tokens``
and ``_add_negative_nsp_samples``:

  * exactly ``int(len * 0.15)`` distinct positions per sequence are
    selected;
  * each selected position: 80% -> mask_id, 10% -> kept, 10% -> uniform
    random id in [0, vocab_len);
  * labels are the ORIGINAL ids at selected positions, -100 elsewhere;
  * NO exclusion of CLS/SEP/PAD positions (the reference's quirk: padding
    can be masked);
  * 25% of rows get their entity half and ELM labels swapped in from a
    random partner row, NSP label 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IGNORE_INDEX = -100


def replace_mlm_tokens(
    tokens,
    vocab_len: int,
    mask_id: int = 103,
    masked_tokens_percentage: float = 0.15,
    unmasked_label_id: int = IGNORE_INDEX,
):
    """Single-sequence masking, signature- and RNG-stream-compatible with the
    reference ``replace_mlm_tokens`` (``indra_for_pretraining.py:33-77``).

    Uses the stdlib ``random`` module with the reference's exact call order
    (sample -> per-position random()/randint), so seeding ``random.seed``
    reproduces the reference's outputs bit-for-bit.  The batched pipelines
    use the vectorized ``mask_tokens`` below instead."""
    import random

    mlm_input_tokens = list(tokens)
    mlm_labels = [unmasked_label_id] * len(mlm_input_tokens)
    candidate_pred_positions = random.sample(
        range(len(mlm_input_tokens)),
        int(len(mlm_input_tokens) * masked_tokens_percentage),
    )
    for pos in candidate_pred_positions:
        if random.random() < 0.8:
            masked_token = mask_id
        elif random.random() < 0.5:
            masked_token = tokens[pos]
        else:
            masked_token = random.randint(0, vocab_len - 1)
        mlm_input_tokens[pos] = masked_token
        mlm_labels[pos] = tokens[pos]
    return mlm_input_tokens, mlm_labels


def mask_tokens(
    tokens: np.ndarray,          # (B, L) int
    vocab_len: int,
    rng: np.random.Generator,
    mask_id: int = 103,
    masked_tokens_percentage: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized 80/10/10 masking. Returns (masked_tokens, labels)."""
    B, L = tokens.shape
    n_pred = int(L * masked_tokens_percentage)
    labels = np.full((B, L), IGNORE_INDEX, np.int64)
    masked = tokens.astype(np.int64).copy()
    if n_pred == 0:
        return masked, labels

    # n_pred distinct positions per row: argpartition of uniform noise
    noise = rng.random((B, L))
    positions = np.argpartition(noise, n_pred - 1, axis=1)[:, :n_pred]  # (B, n_pred)
    rows = np.arange(B)[:, None]

    original = tokens[rows, positions]
    u = rng.random((B, n_pred))
    random_ids = rng.integers(0, vocab_len, (B, n_pred))
    replacement = np.where(
        u < 0.8, mask_id, np.where(u < 0.9, original, random_ids)
    )
    masked[rows, positions] = replacement
    labels[rows, positions] = original
    return masked, labels


def add_negative_nsp_samples(
    features: dict,                # arrays keyed like the reference columns
    rng: np.random.Generator,
    nsp_negative_proportion: float = 0.25,
    text_part_length: int = 256,
) -> dict:
    """Generate non-matching text/entity rows (NSP label 1).

    ``features`` maps input_ids/attention_mask/token_type_ids/
    masked_lm_labels/ent_masked_lm_labels/next_sentence_labels to (N, ...)
    arrays; returns the negative-sample arrays with the same keys."""
    n = len(features["input_ids"])
    k = int(n * nsp_negative_proportion)
    i = rng.choice(n, k, replace=False)   # text rows
    j = rng.choice(n, k, replace=False)   # entity partner rows
    ids = np.concatenate(
        [features["input_ids"][i, :text_part_length],
         features["input_ids"][j, text_part_length:]],
        axis=1,
    )
    return {
        "input_ids": ids,
        "attention_mask": features["attention_mask"][i],
        "token_type_ids": features["token_type_ids"][i],
        "masked_lm_labels": features["masked_lm_labels"][i],
        "ent_masked_lm_labels": features["ent_masked_lm_labels"][j],
        "next_sentence_labels": np.ones(k, np.int64),
    }


def mask_tokens_torch(
    gen: torch.Generator,
    tokens: torch.Tensor,         # (B, L) int
    vocab_len: int,
    mask_id: int = 103,
    masked_tokens_percentage: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device 80/10/10 masking (the JAX package's ``mask_tokens_jax``).

    ``gen`` is a generator on ``tokens``' device.  ``int(L * p)`` distinct
    positions a row are the top-k of uniform noise; each is replaced by
    ``mask_id`` (u < 0.8), kept (u < 0.9) or a uniform id in
    [0, vocab_len).  Returns (masked tokens, labels): the labels hold the
    original ids at the chosen positions and -100 elsewhere."""
    B, L = tokens.shape
    n_pred = int(L * masked_tokens_percentage)
    labels = torch.full((B, L), IGNORE_INDEX, dtype=tokens.dtype, device=tokens.device)
    if n_pred == 0:
        return tokens, labels
    noise = torch.rand((B, L), generator=gen, device=tokens.device)
    positions = torch.topk(noise, n_pred, dim=1, largest=False).indices
    original = torch.gather(tokens, 1, positions)
    u = torch.rand((B, n_pred), generator=gen, device=tokens.device)
    random_ids = torch.randint(0, vocab_len, (B, n_pred), generator=gen,
                               device=tokens.device, dtype=tokens.dtype)
    replacement = torch.where(u < 0.8, torch.full_like(original, mask_id),
                              torch.where(u < 0.9, original, random_ids))
    return (tokens.scatter(1, positions, replacement),
            labels.scatter(1, positions, original))
