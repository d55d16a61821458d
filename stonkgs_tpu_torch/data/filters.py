"""Dataset hygiene utilities.

The port's copy of the JAX package's ``data/filters.py``: the reference's
manual data-cleaning scripts (``filter_evidences.py``,
``filter_for_majority_classes.py``, ``indra_check_overlaps.py``,
``fix_broken_pretraining_dataset.py``) as library functions over pandas
DataFrames (the module itself imports no pandas), and
:func:`reduce_dataset_size` replays scikit-learn's
``train_test_split(stratify=...)`` in numpy
(:func:`~stonkgs_tpu_torch.train.finetuning._stratified_subsample`), so it
keeps the rows scikit-learn keeps without needing it.
"""

from __future__ import annotations

import ast
import logging
import os
from collections import Counter
from typing import Dict, Optional, Set

import numpy as np

from stonkgs_tpu_torch.train.finetuning import _stratified_subsample

logger = logging.getLogger(__name__)

# default per-task class counts (the reference's __main__: 10/10/5/3)
MAJORITY_CLASS_COUNTS = {"cell_line": 10, "disease": 10, "location": 5,
                         "species": 3}


def filter_out_duplicates(df, name: str = ""):
    """Keep only unique text evidences (reference ``filter_evidences.py:30-48``)."""
    len_before = len(df)
    df = df.drop_duplicates(subset="evidence")
    logger.info("%s: %d (before), %d (after), %d removed",
                name, len_before, len(df), len_before - len(df))
    return df


def apply_kg_filtering(df, kg_entity_names: Set[str], name: str = ""):
    """Drop rows whose source or target is not in the pre-trained KG
    (reference ``filter_evidences.py:51-67``)."""
    original = len(df)
    df = df[df["source"].isin(kg_entity_names)
            & df["target"].isin(kg_entity_names)].reset_index(drop=True)
    logger.info("%s: %d of %d triples dropped (nodes not in KG)",
                name, original - len(df), original)
    return df


def _stratified_train_split(df, train_size: int, random_seed: int, column: str):
    """``train_test_split(df, train_size=..., random_state=...,
    stratify=df[column])[0]``: the same rows in the same order."""
    idx = _stratified_subsample(df[column].to_numpy(), train_size, random_seed)
    return df.iloc[idx]


def reduce_dataset_size(df, max_dataset_size: int = 10_000,
                        class_name: str = "class", random_seed: int = 42,
                        name: str = ""):
    """Deterministic stratified downsampling (``filter_evidences.py:70-108``).

    The relation-type dataset is stratified twice: first on ``interaction``
    at 2x the target size, then on ``polarity``."""
    if max_dataset_size >= len(df):
        return df
    if class_name == "class":
        return _stratified_train_split(df, max_dataset_size, random_seed, class_name)
    df = _stratified_train_split(df, max_dataset_size * 2, random_seed, "interaction")
    df = _stratified_train_split(df, max_dataset_size, random_seed, "polarity")
    if name == "relation_type":
        logger.info("Polarity: %s", Counter(df["polarity"]))
        logger.info("Interaction: %s", Counter(df["interaction"]))
    return df


def filter_out_special_character_sequences(
    df, tokenizer, min_tokens: int = 50,
    evidence_col_name: str = "evidence", name: str = "",
):
    """Drop short evidences; strip [ ] XREF \\u markers
    (``filter_evidences.py:111-144``)."""
    initial = len(df)
    evid = df[evidence_col_name].astype(str)
    lengths = np.fromiter(
        (len(tokenizer.tokenize(t)) for t in evid), np.int64, len(evid))
    keep = lengths >= min_tokens
    df = df[keep].reset_index(drop=True)
    cleaned = (
        df[evidence_col_name].astype(str)
        .str.replace("[", "", regex=False)
        .str.replace("]", "", regex=False)
        .str.replace("\\\\u", "", regex=False)
        .str.replace("XREF", "", regex=False)
    )
    n_special = int((cleaned != df[evidence_col_name]).sum())
    df[evidence_col_name] = cleaned
    logger.info(
        "%s: %d of %d entries had special characters; %d removed as too "
        "short; %d remain", name, n_special, initial,
        int((~keep).sum()), len(df))
    return df


def filter_for_majority_classes(df, n_classes: int = 10, name: str = "",
                                output_path: Optional[str] = None):
    """Keep the top-N classes; drops '-1' and merges the deprecated
    EFO:0000887 into UBERON:0002107 (``filter_for_majority_classes.py:25-60``)."""
    df = df[df["class"] != "-1"]
    df = df.replace("0000887", "0002107")
    counts = df["class"].value_counts()
    labels_to_keep = counts[:n_classes].to_dict()
    labels_to_remove = counts[n_classes:].to_dict()
    logger.info("%s majority class occurrences %s", name, labels_to_keep)
    df = df[~df["class"].isin(list(labels_to_remove))]
    logger.info("%s triples after filtering for %d classes: %d",
                name, n_classes, df.shape[0])
    if output_path and name:
        df.to_csv(os.path.join(output_path, name + "_filtered_more_classes.tsv"),
                  sep="\t", index=None)
    return df


def load_entities(df) -> Set[str]:
    """All source/target entities of a dataset (``indra_check_overlaps.py:30-37``)."""
    return set(df["source"]) | set(df["target"])


def find_missing_entities(pre_training_entities: Set[str],
                          fine_tuning_entities: Dict[str, Set[str]]) -> Dict[str, int]:
    """Entities in fine-tuning but not in pre-training (``:44-55``)."""
    out = {}
    for name, ents in fine_tuning_entities.items():
        missing = ents - pre_training_entities
        logger.info("%s: %d fine-tuning entities missing from pre-training",
                    name, len(missing))
        out[name] = len(missing)
    return out


def find_information_leakage(pre_training_evidences: Set[str],
                             fine_tuning_evidences: Dict[str, Set[str]]) -> Dict[str, int]:
    """Evidence strings shared between pre-training and fine-tuning (``:66-77``)."""
    out = {}
    for name, evs in fine_tuning_evidences.items():
        leaked = evs & pre_training_evidences
        logger.info("%s: %d of %d evidences also in pre-training",
                    name, len(leaked), len(evs))
        out[name] = len(leaked)
    return out


def fix_stringified_lists(df, columns=("input_ids", "attention_mask",
                                       "token_type_ids", "masked_lm_labels",
                                       "ent_masked_lm_labels")):
    """Turn int-list columns that a TSV round trip made strings back into
    Python lists (``fix_broken_pretraining_dataset.py:38-70``)."""
    for col in columns:
        if col in df.columns and len(df) and isinstance(df[col].iloc[0], str):
            df[col] = df[col].map(ast.literal_eval)
    return df
