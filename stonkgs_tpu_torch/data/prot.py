"""ProtSTonKGs tri-modality preprocessing.

The port's copy of the JAX package's ``data/prot.py``, after the
reference's ``prot_indra_for_pretraining`` and its fine-tuning variant.

Text part (768) = [CLS] + enc(evidence, len=254, WITH special tokens: the
reference's encode_plus call keeps add_special_tokens=True, so the chunk
contains its own CLS/SEP; quirk kept) + [SEP] + enc(source_desc, 255,
no specials) + [SEP] + enc(target_desc, 255, no specials) + [SEP].

KG part (256) = walk(source) + [SEP_bigbird] + walk(target) + [SEP_bigbird].
Protein part (3072) = enc(source_prot, 1535, no specials) + [SEP_prot] +
enc(target_prot, 1535, no specials) + [SEP_prot].

Each modality is masked with its own mask id / vocab size; no NSP labels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from stonkgs_tpu_torch.data.artifacts import KGArtifacts
from stonkgs_tpu_torch.data.masking import mask_tokens
from stonkgs_tpu_torch.data.wordpiece import BertTokenizer


def _encode_no_specials(tokenizer: BertTokenizer, texts, max_length: int):
    """encode_plus(add_special_tokens=False) with pad/truncate."""
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for i, t in enumerate(texts):
        row = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(t))[:max_length]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask


def assemble_prot_text_part(
    evidences, source_descs, target_descs,
    tokenizer: BertTokenizer,
    text_seq_length: int = 768,
):
    """(B, 768) text ids + attention per the reference layout (:87-124)."""
    B = len(evidences)
    third = text_seq_length // 3
    ev_ids, ev_mask = tokenizer.encode_batch(evidences, third - 2)
    sd_ids, sd_mask = _encode_no_specials(tokenizer, source_descs, third - 1)
    td_ids, td_mask = _encode_no_specials(tokenizer, target_descs, third - 1)
    cls_col = np.full((B, 1), tokenizer.cls_id, np.int32)
    sep_col = np.full((B, 1), tokenizer.sep_id, np.int32)
    one_col = np.ones((B, 1), np.int32)
    ids = np.concatenate(
        [cls_col, ev_ids, sep_col, sd_ids, sep_col, td_ids, sep_col], axis=1)
    mask = np.concatenate(
        [one_col, ev_mask, one_col, sd_mask, one_col, td_mask, one_col], axis=1)
    assert ids.shape[1] == text_seq_length
    return ids, mask


def assemble_prot_seq_part(
    source_prots, target_prots,
    prot_tokenizer: BertTokenizer,
    prot_seq_length: int = 3072,
):
    """(B, 3072) protein ids + attention (:134-160)."""
    B = len(source_prots)
    half = prot_seq_length // 2 - 1
    s_ids, s_mask = _encode_no_specials(prot_tokenizer, source_prots, half)
    t_ids, t_mask = _encode_no_specials(prot_tokenizer, target_prots, half)
    sep_col = np.full((B, 1), prot_tokenizer.sep_id, np.int32)
    one_col = np.ones((B, 1), np.int32)
    ids = np.concatenate([s_ids, sep_col, t_ids, sep_col], axis=1)
    mask = np.concatenate([s_mask, one_col, t_mask, one_col], axis=1)
    assert ids.shape[1] == prot_seq_length
    return ids, mask


def preprocess_prot_for_pretraining(
    rows: Dict[str, Sequence],   # source, target, evidence, source_description,
                                 # target_description, source_prot, target_prot
    artifacts: KGArtifacts,
    lm_tokenizer: BertTokenizer,
    prot_tokenizer: BertTokenizer,
    *,
    text_seq_length: int = 768,
    prot_seq_length: int = 3072,
    bigbird_sep_id: int = 66,
    bigbird_mask_id: int = 67,
    bigbird_unk_id: int = 100,
    lm_mask_id: Optional[int] = None,
    prot_mask_id: Optional[int] = None,
    apply_masking: bool = True,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Batched ``prot_indra_to_pretraining_df``."""
    rng = np.random.default_rng(seed)
    B = len(rows["evidence"])

    text_ids, text_mask = assemble_prot_text_part(
        rows["evidence"], rows["source_description"],
        rows["target_description"], lm_tokenizer, text_seq_length)

    src = np.asarray(rows["source"], object)
    tgt = np.asarray(rows["target"], object)
    sw = artifacts.walks_for(src, unk_id=bigbird_unk_id)
    tw = artifacts.walks_for(tgt, unk_id=bigbird_unk_id)
    sep = np.full((B, 1), bigbird_sep_id, np.int32)
    ent_ids = np.concatenate([sw, sep, tw, sep], axis=1).astype(np.int64)

    prot_ids, prot_mask = assemble_prot_seq_part(
        rows["source_prot"], rows["target_prot"], prot_tokenizer,
        prot_seq_length)

    if apply_masking:
        text_ids, mlm_labels = mask_tokens(
            text_ids.astype(np.int64), lm_tokenizer.vocab_size, rng,
            lm_mask_id if lm_mask_id is not None else lm_tokenizer.mask_id)
        ent_ids, elm_labels = mask_tokens(
            ent_ids, artifacts.n_entities, rng, bigbird_mask_id)
        prot_ids, prot_labels = mask_tokens(
            prot_ids.astype(np.int64), prot_tokenizer.vocab_size, rng,
            prot_mask_id if prot_mask_id is not None else prot_tokenizer.mask_id)
    else:
        text_ids = text_ids.astype(np.int64)
        prot_ids = prot_ids.astype(np.int64)
        mlm_labels = np.full_like(text_ids, -100)
        elm_labels = np.full_like(ent_ids, -100)
        prot_labels = np.full_like(prot_ids, -100)

    ent_len = ent_ids.shape[1]
    return {
        "input_ids": np.concatenate([text_ids, ent_ids, prot_ids], axis=1),
        "attention_mask": np.concatenate(
            [text_mask, np.ones((B, ent_len), np.int32), prot_mask],
            axis=1).astype(np.int64),
        "masked_lm_labels": mlm_labels,
        "ent_masked_lm_labels": elm_labels,
        "prot_masked_lm_labels": prot_labels,
    }


def preprocess_prot_for_finetuning(
    rows: Dict[str, Sequence],
    labels,
    artifacts: KGArtifacts,
    lm_tokenizer: BertTokenizer,
    prot_tokenizer: BertTokenizer,
    **kw,
) -> Dict[str, np.ndarray]:
    """ProtSTonKGs fine-tuning features: no masking + labels column."""
    feats = preprocess_prot_for_pretraining(
        rows, artifacts, lm_tokenizer, prot_tokenizer,
        apply_masking=False, **kw,
    )
    return {
        "input_ids": feats["input_ids"],
        "attention_mask": feats["attention_mask"],
        "labels": np.asarray(labels),
    }
