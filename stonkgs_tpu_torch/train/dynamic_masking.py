"""On-device dynamic masking and NSP pairing for pre-training.

The port of the JAX package's ``stonkgs_tpu/train/dynamic_masking.py``.
The reference masks its corpus once during preprocessing, so every epoch
sees the same corruptions.  :func:`dynamic_masking_loss` applies the same
80/10/10 masking and NSP pairing inside the train step with fresh
randomness at every step (RoBERTa-style dynamic masking): the stored
dataset stays uncorrupted.  NSP negatives are made by swapping rows in
place (a batch cannot grow inside the step), so the default
``nsp_negative_proportion=0.2`` matches the reference's 20% class prior.

Usage: preprocess with ``apply_masking=False`` (raw token ids) and pass
``loss_fn=dynamic_masking_loss()`` to ``pretrain`` / ``make_train_step``.
The masks are drawn on the batch's device from generators seeded by the
step's :class:`~stonkgs_tpu_torch.models.bert.DropoutRng`, so a step
replays from (seed, step) as the dropout does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from stonkgs_tpu_torch.data.masking import mask_tokens_torch
from stonkgs_tpu_torch.models import stonkgs
from stonkgs_tpu_torch.models.bert import DropoutRng


def dynamic_nsp_swap(gen: torch.Generator, input_ids: torch.Tensor,
                     ent_labels: torch.Tensor, text_len: int,
                     negative_proportion: float = 0.2):
    """Swap the entity half (and its ELM labels) of ~``negative_proportion``
    of the rows with a random partner row's, NSP label 1 (the reference's
    class prior, applied a batch at a time).  ``gen`` is a generator on
    the tensors' device.  Returns (input_ids, ent_labels, nsp labels)."""
    B = input_ids.shape[0]
    is_neg = torch.rand((B,), generator=gen, device=input_ids.device) < negative_proportion
    partner = torch.randperm(B, generator=gen, device=input_ids.device)
    ent = input_ids[:, text_len:]
    swapped_ent = torch.where(is_neg[:, None], ent[partner], ent)
    swapped_labels = torch.where(is_neg[:, None], ent_labels[partner], ent_labels)
    input_ids = torch.cat([input_ids[:, :text_len], swapped_ent], dim=1)
    return input_ids, swapped_labels, is_neg.to(input_ids.dtype)


def _generators(rng: DropoutRng, device, n: int):
    """``n`` generators on ``device``, seeded from ``rng.host``."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=rng.host)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def dynamic_masking_loss(
    *,
    base_loss: Callable = stonkgs.pretraining_loss,
    mask_id: int = 103,
    masked_tokens_percentage: float = 0.15,
    nsp_negative_proportion: Optional[float] = 0.2,
) -> Callable:
    """A loss that masks (and, unless ``nsp_negative_proportion`` is falsy,
    pairs NSP negatives) on the device before ``base_loss``.

    Expects batches with raw ``input_ids``; the label columns are made
    here.  The masking generators are drawn from the step's ``rng``
    before ``base_loss`` draws its dropout from it."""

    def loss(params, cfg, batch, *, rng: Optional[DropoutRng] = None, **kw):
        if rng is None:
            raise ValueError("dynamic masking needs the step's rng")
        ids = batch["input_ids"]
        g_text, g_ent, g_nsp = _generators(rng, ids.device, 3)
        text_m, mlm_labels = mask_tokens_torch(
            g_text, ids[:, : cfg.text_len], cfg.bert.vocab_size,
            mask_id, masked_tokens_percentage)
        ent_m, elm_labels = mask_tokens_torch(
            g_ent, ids[:, cfg.text_len:], cfg.kg_vocab_size,
            mask_id, masked_tokens_percentage)
        input_ids = torch.cat([text_m, ent_m], dim=1)
        if nsp_negative_proportion:
            input_ids, elm_labels, nsp = dynamic_nsp_swap(
                g_nsp, input_ids, elm_labels, cfg.text_len, nsp_negative_proportion)
        else:
            nsp = torch.zeros(input_ids.shape[0], dtype=input_ids.dtype,
                              device=input_ids.device)
        new_batch = {
            **batch,
            "input_ids": input_ids,
            "masked_lm_labels": mlm_labels,
            "ent_masked_lm_labels": elm_labels,
            "next_sentence_labels": nsp,
        }
        return base_loss(params, cfg, new_batch, rng=rng, **kw)

    return loss
