"""Fine-tuning entry points and the 10-task battery of the reference benchmark.

The port of the JAX package's ``stonkgs_tpu/cli/finetune.py``: one task
is a TSV of (source, target, evidence, class) rows, filtered to the pairs
whose nodes are in the KG, preprocessed, and fine-tuned with
cross-validation from a checkpoint loaded by
:meth:`~stonkgs_tpu_torch.api.inference.STonKGsEngine.from_pretrained`,
on the card unless the caller asks for the CPU.  pandas is imported only
to read the task TSV.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

# (directory name, file name, class column, task name)
ALL_TASKS = [
    ("cell_line", "cell_line_ppi_prot.tsv", "class", "cell_line"),
    ("cell_type", "cell_type_ppi_prot.tsv", "class", "cell_type"),
    ("correct_incorrect", "correct_incorrect_binary_ppi_prot.tsv", "class", "correct_binary"),
    ("correct_incorrect", "correct_incorrect_multiclass_ppi_prot.tsv",
     "class", "correct_multiclass"),
    ("disease", "disease_ppi_prot.tsv", "class", "disease"),
    ("location", "location_ppi_prot.tsv", "class", "location"),
    ("organ", "organ_ppi_prot.tsv", "class", "organ"),
    ("species", "species_ppi_prot.tsv", "class", "species"),
    ("relation_type", "relation_type_ppi_prot.tsv", "interaction", "interaction"),
    ("relation_type", "relation_type_ppi_prot.tsv", "polarity", "polarity"),
]


def run_finetuning(
    train_data_path: str,
    model_path: str,
    kg_embedding_path: str,
    kg_walks_path: str,
    vocab_file: str,
    *,
    class_column_name: str = "class",
    epochs: int = 5,
    cv: int = 5,
    lr: float = 5e-5,
    batch_size: int = 8,
    max_dataset_size: int = 100_000,
    output_dir: str = "stonkgs-finetuning",
    task_name: str = "",
    compute_dtype: str = "bfloat16",
    device: str = "cuda",
):
    """One task: preprocess the TSV, CV fine-tune; the weighted F1 (and,
    in ``output_dir``, the predictions, the run log and the model)."""
    import pandas as pd

    from stonkgs_tpu_torch.api.inference import STonKGsEngine
    from stonkgs_tpu_torch.data.preprocessing import preprocess_for_finetuning
    from stonkgs_tpu_torch.train.finetuning import (
        FinetuneConfig,
        run_sequence_classification_cv,
    )
    from stonkgs_tpu_torch.utils.logging import RunLogger

    engine = STonKGsEngine.from_pretrained(
        model_path, kg_embedding_path, kg_walks_path, vocab_file=vocab_file, device=device)
    df = pd.read_csv(train_data_path, sep="\t",
                     usecols=["source", "target", "evidence", class_column_name])
    # only pairs whose nodes are both in the KG, as the reference
    known = set(engine.artifacts.name_to_idx)
    df = df[df["source"].isin(known) & df["target"].isin(known)].reset_index(drop=True)
    feats = preprocess_for_finetuning(
        df["source"].to_numpy(object), df["target"].to_numpy(object),
        df["evidence"].tolist(), df[class_column_name].to_numpy(object),
        engine.artifacts, engine.tokenizer,
    )
    labels = feats.pop("labels")
    run_cfg = FinetuneConfig(epochs=epochs, lr=lr, batch_size=batch_size, cv=cv,
                             max_dataset_size=max_dataset_size, compute_dtype=compute_dtype)
    with RunLogger(log_dir=output_dir, experiment="STonKGs Fine-Tuning") as log:
        result = run_sequence_classification_cv(
            feats, labels, engine.params, engine.cfg, run_cfg,
            task_name=task_name, output_dir=output_dir, logger=log)
    logger.info("Mean f1-score: %s", result["f1_score_mean"])
    logger.info("Std f1-score: %s", result["f1_score_std"])
    return result


def run_all_fine_tuning_tasks(input_dir: str, **kw):
    """Every task of :data:`ALL_TASKS` whose TSV is under ``input_dir``;
    ``kw`` go to :func:`run_finetuning`."""
    results = {}
    for directory, file_name, column, task in ALL_TASKS:
        path = os.path.join(input_dir, directory, file_name)
        if not os.path.exists(path):
            logger.warning("skipping %s: %s not found", task, path)
            continue
        results[task] = run_finetuning(path, class_column_name=column, task_name=task, **kw)
        logger.info("Finished the %s task", task)
    return results
