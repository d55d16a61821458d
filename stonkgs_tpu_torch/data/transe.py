"""TransE-variant preprocessing.

The port's copy of the JAX package's ``data/transe.py``.  Sequence
layout: 256 text tokens + ``[idx(h), idx(r), idx(t), SEP]``.  Rows whose
head, relation or tail is missing from the TransE embeddings are skipped
and counted, as the reference's ``transe_indra_for_pretraining`` does.
:func:`transe_pretraining_to_tsv` writes the pre-training features in
chunks with a resume, byte for byte as the JAX package's pandas writer
does, without pandas.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from stonkgs_tpu_torch.data.artifacts import parse_vectors, read_tsv
from stonkgs_tpu_torch.data.masking import add_negative_nsp_samples, mask_tokens
from stonkgs_tpu_torch.data.tsv_io import count_records, write_table
from stonkgs_tpu_torch.data.wordpiece import BertTokenizer


@dataclasses.dataclass
class TransEArtifacts:
    """TransE embedding table over KG nodes AND relations."""

    names: list
    name_to_idx: Dict[str, int]
    vectors: np.ndarray   # (N, H) float32

    @property
    def n_entities(self) -> int:
        return len(self.names)

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


def load_transe_artifacts(embedding_path, sep: str = "\t") -> TransEArtifacts:
    """Load a TransE entity/relation embedding TSV into lookup tables
    (names kept verbatim, as ``data/artifacts.py`` reads them)."""
    names, rests = read_tsv(embedding_path, sep)
    return TransEArtifacts(
        names=names,
        name_to_idx={n: i for i, n in enumerate(names)},
        vectors=parse_vectors(rests, sep),
    )


def assemble_transe_part(
    sources: Sequence[str],
    relations: Sequence[str],
    targets: Sequence[str],
    artifacts: TransEArtifacts,
    sep_id: int = 102,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (N, 4) [h, r, t, SEP] index rows.

    Returns (rows, keep_mask): rows with any missing name are flagged False
    (the reference skips them with a KeyError counter)."""
    n = len(sources)
    out = np.zeros((n, 4), np.int64)
    keep = np.ones(n, bool)
    g = artifacts.name_to_idx.get
    for i, (s, r, t) in enumerate(zip(sources, relations, targets)):
        hs, hr, ht = g(s, -1), g(r, -1), g(t, -1)
        if hs < 0 or hr < 0 or ht < 0:
            keep[i] = False
            continue
        out[i] = (hs, hr, ht, sep_id)
    return out, keep


def preprocess_transe_for_pretraining(
    sources, relations, targets, evidences,
    artifacts: TransEArtifacts,
    tokenizer: BertTokenizer,
    *,
    text_part_length: int = 256,
    sep_id: int = 102,
    mask_id: int = 103,
    nsp_negative_proportion: float = 0.25,
    seed: int = 0,
    shuffle: bool = True,
) -> Tuple[Dict[str, np.ndarray], int]:
    """Batched TransE pre-training preprocessing.

    Returns (features, skip_count)."""
    rng = np.random.default_rng(seed)
    ent_ids, keep = assemble_transe_part(
        sources, relations, targets, artifacts, sep_id
    )
    skip_count = int((~keep).sum())
    evidences = [e for e, k in zip(evidences, keep) if k]
    ent_ids = ent_ids[keep]
    B = len(evidences)

    text_ids, text_mask = tokenizer.encode_batch(evidences, text_part_length)
    text_ids, mlm_labels = mask_tokens(
        text_ids.astype(np.int64), tokenizer.vocab_size, rng, mask_id)
    # masking over the 4-slot entity part: int(4*0.15)=0 -> no-op, but kept
    # for behavioral parity with replace_mlm_tokens
    ent_ids, elm_labels = mask_tokens(
        ent_ids, artifacts.n_entities, rng, mask_id)

    positives = {
        "input_ids": np.concatenate([text_ids, ent_ids], axis=1),
        "attention_mask": np.concatenate(
            [text_mask, np.ones((B, 4), np.int32)], axis=1).astype(np.int64),
        "token_type_ids": np.concatenate(
            [np.zeros((B, text_part_length), np.int64),
             np.ones((B, 4), np.int64)], axis=1),
        "masked_lm_labels": mlm_labels,
        "ent_masked_lm_labels": elm_labels,
        "next_sentence_labels": np.zeros(B, np.int64),
    }
    negatives = add_negative_nsp_samples(
        positives, rng, nsp_negative_proportion,
        text_part_length=text_part_length,
    )
    out = {k: np.concatenate([positives[k], negatives[k]], 0) for k in positives}
    if shuffle:
        perm = rng.permutation(len(out["input_ids"]))
        out = {k: v[perm] for k, v in out.items()}
    return out, skip_count


def preprocess_transe_for_finetuning(
    sources, relations, targets, evidences, labels,
    artifacts: TransEArtifacts,
    tokenizer: BertTokenizer,
    *,
    text_part_length: int = 256,
    sep_id: int = 102,
    ent_part=None,  # precomputed (ent_ids, keep) from assemble_transe_part
) -> Dict[str, np.ndarray]:
    """TransE fine-tuning features (no masking, keeps labels).

    Reference: ``transestonkgs_finetuning.py:141-167``; rows with unknown
    names are dropped together with their labels."""
    if ent_part is None:
        ent_part = assemble_transe_part(
            sources, relations, targets, artifacts, sep_id
        )
    ent_ids, keep = ent_part
    evidences = [e for e, k in zip(evidences, keep) if k]
    labels = np.asarray(labels)[keep]
    ent_ids = ent_ids[keep]
    B = len(evidences)
    text_ids, text_mask = tokenizer.encode_batch(evidences, text_part_length)
    return {
        "input_ids": np.concatenate([text_ids.astype(np.int64), ent_ids], 1),
        "attention_mask": np.concatenate(
            [text_mask, np.ones((B, 4), np.int32)], 1).astype(np.int64),
        "token_type_ids": np.concatenate(
            [np.zeros((B, text_part_length), np.int64),
             np.ones((B, 4), np.int64)], 1),
        "labels": labels,
    }


def transe_pretraining_to_tsv(
    df,                      # a table: source, relation, target, evidence columns
    artifacts: TransEArtifacts,
    tokenizer: BertTokenizer,
    output_path: str,
    *,
    chunk_size: int = 50_000,
    seed: int = 0,
    **kw,
) -> int:
    """Chunked, resumable positive-sample generation (appends to TSV).

    ``df`` is a DataFrame or a dict of column lists.  Resume tracks the
    number of INPUT rows consumed in a ``<output>.progress`` sidecar (the
    reference resumes by counting OUTPUT rows, ``:51-69``, which
    re-processes rows whenever earlier chunks skipped some); an existing
    output without a sidecar falls back to the reference's output-row
    count.  A 2-D feature is written one row a cell, as ``str`` of the
    row (pandas' cell of a list of arrays).  Returns total skip count."""
    progress_path = output_path + ".progress"
    done = 0
    header_written = False
    if os.path.exists(output_path):
        if os.path.getsize(output_path) > 0:
            header_written = True
            if os.path.exists(progress_path):
                with open(progress_path) as f:
                    done = int(f.read().strip() or 0)
            else:  # an output without a sidecar: the output-row count
                done = count_records(output_path)
        else:
            os.remove(output_path)  # stale empty file: start fresh
    cols = {k: list(df[k]) for k in ("source", "relation", "target", "evidence")}
    total_skips = 0
    for start in range(done, len(cols["source"]), chunk_size):
        stop = min(start + chunk_size, len(cols["source"]))
        feats, skips = preprocess_transe_for_pretraining(
            *(cols[k][start:stop] for k in ("source", "relation", "target", "evidence")),
            artifacts, tokenizer, nsp_negative_proportion=0.0, seed=seed + start,
            shuffle=False, **kw)
        total_skips += skips
        write_table(output_path, {k: list(v) for k, v in feats.items()}, mode="a",
                    header=not header_written)
        header_written = True
        with open(progress_path, "w") as f:
            f.write(str(stop))
    return total_skips
