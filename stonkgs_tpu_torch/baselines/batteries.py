"""8-task benchmark batteries for the NLP and KG baselines.

The port's copy of the JAX package's ``baselines/batteries.py`` (the
reference's ``nlp_baseline_model.py:303-371`` and
``kg_baseline_model.py:549-614``): both iterate the same 8 tasks
(cell_line, correct binary/multiclass, disease, location, species,
interaction, polarity) over ``*_no_duplicates.tsv`` files, on the port's
baselines.  A task whose file is missing is skipped.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

from stonkgs_tpu_torch.baselines.kg_baseline import (
    build_node2vec_features,
    build_transe_features,
    run_kg_baseline_cv,
)
from stonkgs_tpu_torch.baselines.nlp_baseline import preprocess_evidences, run_nlp_baseline_cv
from stonkgs_tpu_torch.data.filters import apply_kg_filtering

logger = logging.getLogger(__name__)

# (directory, file name, class column, task name) — reference :316-348
BASELINE_TASKS = [
    ("cell_line", "cell_line_no_duplicates.tsv", "class", "cell_line"),
    ("correct_incorrect", "correct_incorrect_binary_no_duplicates.tsv",
     "class", "correct_binary"),
    ("correct_incorrect", "correct_incorrect_multiclass_no_duplicates.tsv",
     "class", "correct_multiclass"),
    ("disease", "disease_no_duplicates.tsv", "class", "disease"),
    ("location", "location_no_duplicates.tsv", "class", "location"),
    ("species", "species_no_duplicates.tsv", "class", "species"),
    ("relation_type", "relation_type_no_duplicates.tsv", "interaction",
     "interaction"),
    ("relation_type", "relation_type_no_duplicates.tsv", "polarity",
     "polarity"),
]


def _iter_tasks(input_dir: str):
    """(task, class column, DataFrame) of each task whose file exists."""
    import pandas as pd

    for directory, file_name, column, task in BASELINE_TASKS:
        path = os.path.join(input_dir, directory, file_name)
        if not os.path.exists(path):
            logger.warning("skipping %s: %s not found", task, path)
            continue
        df = pd.read_csv(path, sep="\t")
        yield task, column, df


def run_all_nlp_baseline_tasks(
    input_dir: str,
    cfg,                     # BertConfig
    tokenizer,
    *,
    kg_entity_names=None,    # comparability filter (nlp_baseline :126-136)
    pretrained_bert=None,
    max_length: int = 512,
    **kw,
) -> Dict[str, dict]:
    """NLP baseline over the 8-task battery; returns per-task F1 results."""

    results = {}
    for task, column, df in _iter_tasks(input_dir):
        if kg_entity_names is not None:
            df = apply_kg_filtering(df, kg_entity_names, name=task)
        feats = preprocess_evidences(df["evidence"].tolist(), tokenizer,
                                     max_length=max_length)
        results[task] = run_nlp_baseline_cv(
            cfg, feats, df[column].to_numpy(object),
            pretrained_bert=pretrained_bert, task_name=task, **kw)
        logger.info("Finished the %s task", task)
    return results


def run_all_kg_baseline_tasks(
    input_dir: str,
    artifacts,               # KGArtifacts | TransEArtifacts
    *,
    variant: str = "node2vec",
    **kw,
) -> Dict[str, dict]:
    """KG baseline over the 8-task battery (node2vec or TransE features)."""

    results = {}
    for task, column, df in _iter_tasks(input_dir):
        if variant == "transe":
            feats = build_transe_features(
                artifacts, df["source"].tolist(), df["relation"].tolist(),
                df["target"].tolist())
        else:
            feats = build_node2vec_features(
                artifacts, df["source"].tolist(), df["target"].tolist())
        results[task] = run_kg_baseline_cv(
            feats, df[column].to_numpy(object), task_name=task, **kw)
        logger.info("Finished the %s task", task)
    return results
