"""Batched text-triple preprocessing: rows -> model features.

The port's copy of the JAX package's ``data/preprocessing.py``, array
assembly in place of the reference's row-wise pandas loops for its three
preprocessors: embedding extraction (``preprocess_df_for_embeddings``),
fine-tuning (``preprocess_fine_tuning_data``) and pre-training
(``indra_to_pretraining_df``).

All three share the same dual-half layout: text half = tokenized evidence
(CLS..SEP, padded) of length ``half_length``; entity half =
``walk(source) + [SEP] + walk(target) + [SEP]``; token_type_ids =
``[0]*half + [1]*half``; attention = text mask + all-ones entity half.

The reference's quirk is kept: it applies 15% random masking in the
embedding-extraction path too, controlled here by ``apply_masking``
(default True, as the reference; pass False for deterministic
embeddings).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from stonkgs_tpu_torch.data.artifacts import KGArtifacts
from stonkgs_tpu_torch.data.masking import add_negative_nsp_samples, mask_tokens
from stonkgs_tpu_torch.data.wordpiece import BertTokenizer


def assemble_entity_half(
    sources: np.ndarray,   # (B,) entity names (object array) or indices
    targets: np.ndarray,
    artifacts: KGArtifacts,
    sep_id: int = 102,
    unk_id: int = 100,
) -> np.ndarray:
    """(B, 2*rw_len + 2) int32: walk(source) + SEP + walk(target) + SEP."""
    if sources.dtype.kind in "iu":
        sw = artifacts.walk_indices[sources]
        tw = artifacts.walk_indices[targets]
    else:
        sw = artifacts.walks_for(sources, unk_id)
        tw = artifacts.walks_for(targets, unk_id)
    B = len(sources)
    sep = np.full((B, 1), sep_id, np.int32)
    return np.concatenate([sw, sep, tw, sep], axis=1).astype(np.int32)


def _base_features(
    sources: np.ndarray,
    targets: np.ndarray,
    evidences: Sequence[str],
    artifacts: KGArtifacts,
    tokenizer: BertTokenizer,
    sep_id: int,
    unk_id: int,
) -> Tuple[Dict[str, np.ndarray], int]:
    half_length = artifacts.rw_len * 2 + 2
    text_ids, text_mask = tokenizer.encode_batch(evidences, half_length)
    ent_ids = assemble_entity_half(sources, targets, artifacts, sep_id, unk_id)
    assert ent_ids.shape[1] == half_length
    B = len(evidences)
    features = {
        "text_ids": text_ids.astype(np.int64),
        "ent_ids": ent_ids.astype(np.int64),
        "attention_mask": np.concatenate(
            [text_mask, np.ones((B, half_length), np.int32)], axis=1
        ).astype(np.int64),
        "token_type_ids": np.concatenate(
            [np.zeros((B, half_length), np.int32),
             np.ones((B, half_length), np.int32)], axis=1
        ).astype(np.int64),
    }
    return features, half_length


def preprocess_for_embeddings(
    sources: np.ndarray,
    targets: np.ndarray,
    evidences: Sequence[str],
    artifacts: KGArtifacts,
    tokenizer: BertTokenizer,
    *,
    sep_id: int = 102,
    unk_id: int = 100,
    mask_id: int = 103,
    apply_masking: bool = True,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Batched ``preprocess_df_for_embeddings`` (reference rows -> arrays)."""
    f, _ = _base_features(sources, targets, evidences, artifacts, tokenizer,
                          sep_id, unk_id)
    rng = np.random.default_rng(seed)
    if apply_masking:
        text_ids, mlm_labels = mask_tokens(
            f["text_ids"], tokenizer.vocab_size, rng, mask_id)
        ent_ids, elm_labels = mask_tokens(
            f["ent_ids"], artifacts.n_entities, rng, mask_id)
    else:
        text_ids, ent_ids = f["text_ids"], f["ent_ids"]
        mlm_labels = np.full_like(text_ids, -100)
        elm_labels = np.full_like(ent_ids, -100)
    B = len(evidences)
    return {
        "input_ids": np.concatenate([text_ids, ent_ids], axis=1),
        "attention_mask": f["attention_mask"],
        "token_type_ids": f["token_type_ids"],
        "masked_lm_labels": mlm_labels,
        "ent_masked_lm_labels": elm_labels,
        "next_sentence_labels": np.zeros(B, np.int64),
    }


def preprocess_for_finetuning(
    sources: np.ndarray,
    targets: np.ndarray,
    evidences: Sequence[str],
    labels: np.ndarray,
    artifacts: KGArtifacts,
    tokenizer: BertTokenizer,
    *,
    sep_id: int = 102,
    unk_id: int = 100,
) -> Dict[str, np.ndarray]:
    """Batched ``preprocess_fine_tuning_data``: no masking, adds labels."""
    f, _ = _base_features(sources, targets, evidences, artifacts, tokenizer,
                          sep_id, unk_id)
    return {
        "input_ids": np.concatenate([f["text_ids"], f["ent_ids"]], axis=1),
        "attention_mask": f["attention_mask"],
        "token_type_ids": f["token_type_ids"],
        "labels": np.asarray(labels),
    }


def preprocess_for_pretraining(
    sources: np.ndarray,
    targets: np.ndarray,
    evidences: Sequence[str],
    artifacts: KGArtifacts,
    tokenizer: BertTokenizer,
    *,
    sep_id: int = 102,
    unk_id: int = 100,
    mask_id: int = 103,
    nsp_negative_proportion: float = 0.25,
    seed: int = 0,
    shuffle: bool = True,
) -> Dict[str, np.ndarray]:
    """Batched ``indra_to_pretraining_df``: masking + NSP negatives + shuffle."""
    rng = np.random.default_rng(seed)
    f, half_length = _base_features(sources, targets, evidences, artifacts,
                                    tokenizer, sep_id, unk_id)
    text_ids, mlm_labels = mask_tokens(
        f["text_ids"], tokenizer.vocab_size, rng, mask_id)
    ent_ids, elm_labels = mask_tokens(
        f["ent_ids"], artifacts.n_entities, rng, mask_id)
    B = len(evidences)
    positives = {
        "input_ids": np.concatenate([text_ids, ent_ids], axis=1),
        "attention_mask": f["attention_mask"],
        "token_type_ids": f["token_type_ids"],
        "masked_lm_labels": mlm_labels,
        "ent_masked_lm_labels": elm_labels,
        "next_sentence_labels": np.zeros(B, np.int64),
    }
    negatives = add_negative_nsp_samples(
        positives, rng, nsp_negative_proportion, text_part_length=half_length
    )
    out = {
        k: np.concatenate([positives[k], negatives[k]], axis=0)
        for k in positives
    }
    if shuffle:
        perm = rng.permutation(len(out["input_ids"]))
        out = {k: v[perm] for k, v in out.items()}
    return out
