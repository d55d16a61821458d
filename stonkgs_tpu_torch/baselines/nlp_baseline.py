"""NLP-only baseline: BioBERT sequence classification on the evidence text.

The port of the JAX package's ``stonkgs_tpu/baselines/nlp_baseline.py``:
a whole BERT encoder and a classifier on its pooled output (HF
``BertForSequenceClassification``), trained together (the key ``bert``
is not a frozen backbone) with the fine-tuning harness's splits and
weighted F1.  It runs on the card unless the caller asks for the CPU:
training goes through the training kernels, evaluation through the
serving ones.  The default compute dtype is fp32, as in the JAX package;
on the card that runs the fp32 bodies.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from stonkgs_tpu_torch.config import BertConfig
from stonkgs_tpu_torch.models import bert
from stonkgs_tpu_torch.models.bert import DropoutRng
from stonkgs_tpu_torch.models.heads import classifier_head, init_classifier_head
from stonkgs_tpu_torch.models.stonkgs import classification_metrics
from stonkgs_tpu_torch.train.finetuning import (
    encode_labels,
    get_train_test_splits,
    weighted_f1,
    write_predictions,
)
from stonkgs_tpu_torch.train.optimizer import AdamW
from stonkgs_tpu_torch.train.pretraining import (
    data_iterator,
    init_train_state,
    make_train_step,
    to_device,
)
from stonkgs_tpu_torch.utils.batching import batched_apply
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map


def preprocess_evidences(evidences, tokenizer, max_length: int = 512) -> Dict[str, np.ndarray]:
    """Tokenize evidence-only inputs (truncation and padding)."""
    ids, mask = tokenizer.encode_batch(list(evidences), max_length)
    return {"input_ids": np.asarray(ids).astype(np.int64),
            "attention_mask": np.asarray(mask).astype(np.int64)}


def init_nlp_baseline_params(gen: torch.Generator, cfg: BertConfig, num_labels: int,
                             pretrained_bert: Optional[dict] = None) -> dict:
    """BERT encoder (``pretrained_bert`` where given, as is) and a
    classifier head drawn from ``gen``, fp32 on the CPU."""
    return {
        "bert": pretrained_bert if pretrained_bert is not None
        else bert.init_bert_params(gen, cfg, with_pooler=True),
        "classifier": init_classifier_head(gen, cfg, num_labels),
    }


def classification_logits(
    params: dict, cfg: BertConfig, batch: dict, *,
    deterministic: bool = True, rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """BERT on the evidence, then dropout (training) and the classifier
    on the pooled output."""
    _, pooled = bert.bert_model(
        params["bert"], cfg, input_ids=batch["input_ids"],
        attention_mask=batch.get("attention_mask"), deterministic=deterministic, rng=rng,
        compute_dtype=compute_dtype)
    return classifier_head(params["classifier"], pooled, dropout_prob=cfg.hidden_dropout_prob,
                           rng=rng, deterministic=deterministic)


def classification_loss(params: dict, cfg: BertConfig, batch: dict, **kw):
    """Cross entropy and accuracy: (loss, {"loss", "accuracy"})."""
    return classification_metrics(classification_logits(params, cfg, batch, **kw),
                                  batch["labels"])


def train_nlp_baseline(
    cfg: BertConfig,
    params: dict,
    features: Dict[str, np.ndarray],
    *,
    epochs: int = 5,
    lr: float = 5e-5,
    batch_size: int = 16,
    seed: int = 0,
    compute_dtype: str = "float32",
) -> dict:
    """AdamW (clip 1.0, linear decay) over the tokenized evidences, on the
    parameters' device; updates ``params`` in place and returns them."""
    device = tree_leaves(params)[0].device
    total_steps = max(len(features["input_ids"]) // batch_size, 1) * epochs
    tx = AdamW(learning_rate=lr, total_steps=total_steps)
    state = init_train_state(params, tx, seed)
    step_fn = make_train_step(cfg, tx, loss_fn=classification_loss,
                              compute_dtype=getattr(torch, compute_dtype))
    it = data_iterator(features, batch_size, seed=seed)
    for _ in range(total_steps):
        state, _ = step_fn(state, to_device(next(it), device))
    return state.params


def predict(params: dict, cfg: BertConfig, features: Dict[str, np.ndarray], *,
            batch_size: int = 64, compute_dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Predicted class ids over a tokenized evaluation set."""
    logits = batched_apply(
        lambda chunk: classification_logits(params, cfg, chunk, compute_dtype=compute_dtype),
        features, ("input_ids", "attention_mask"), batch_size, tree_leaves(params)[0].device)
    return logits.argmax(axis=1)


def run_nlp_baseline_cv(
    cfg: BertConfig,
    features: Dict[str, np.ndarray],
    labels_str,
    pretrained_bert: Optional[dict] = None,
    *,
    epochs: int = 5,
    lr: float = 5e-5,
    batch_size: int = 16,
    cv: int = 5,
    seed: int = 42,
    compute_dtype: str = "float32",
    logger=None,
    task_name: str = "",
    output_dir: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, float]:
    """Cross-validated weighted F1 of evidence-only classification, each
    fold from a copy of ``pretrained_bert`` (or a fresh encoder) on
    ``device``; ``output_dir`` gets ``predicted_labels_nlp_{task}df.tsv``."""
    labels, tag2id, id2tag = encode_labels(list(labels_str))
    splits = get_train_test_splits(labels, random_seed=seed, n_splits=cv)
    f1s, rows = [], []
    for fold, idx in enumerate(splits):
        params = init_nlp_baseline_params(torch.Generator().manual_seed(seed + fold), cfg,
                                          len(tag2id), pretrained_bert=pretrained_bert)
        # a copy on the device: the step updates in place
        params = tree_map(lambda t: t.detach().to(device, copy=True), params)
        train_feats = {k: v[idx["train_idx"]] for k, v in features.items()}
        train_feats["labels"] = labels[idx["train_idx"]]
        params = train_nlp_baseline(cfg, params, train_feats, epochs=epochs, lr=lr,
                                    batch_size=batch_size, seed=seed + fold,
                                    compute_dtype=compute_dtype)
        pred = predict(params, cfg, {k: v[idx["test_idx"]] for k, v in features.items()},
                       compute_dtype=getattr(torch, compute_dtype))
        f1 = weighted_f1(labels[idx["test_idx"]], pred)
        f1s.append(f1)
        rows.append((fold, idx["test_idx"], pred, labels[idx["test_idx"]]))
        if logger:
            logger.log_metric("f1_score_weighted", f1, step=fold)
    result = {"f1_score_mean": float(np.mean(f1s)), "f1_score_std": float(np.std(f1s))}
    if logger:
        logger.log_param("task name", task_name)
        logger.log_metrics(result)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        write_predictions(os.path.join(output_dir, f"predicted_labels_nlp_{task_name}df.tsv"),
                          rows, id2tag)
    return result
