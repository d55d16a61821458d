"""KG-only baseline: max-pool over walk embeddings, then a linear classifier.

The port of the JAX package's ``stonkgs_tpu/baselines/kg_baseline.py``:

* features: node2vec, (N, 2·rw_len, dim) from the source's and the
  target's random-walk embeddings, zeros for a node outside the KG; or
  TransE, (N, 3, dim) for head, relation and tail;
* model: max-pool over the walk axis -> dropout(0.1) -> linear -> softmax;
* loss: cross entropy weighted by inverse class counts of the train
  split.  Quirk kept on purpose: the reference feeds the softmax
  PROBABILITIES to ``CrossEntropyLoss`` (a double softmax);
* AdamW (``torch.optim.AdamW``, weight decay 1e-4 as ``optax.adamw``'s
  default), lr 1e-3, every batch of an epoch trained, the tail one too.

The JAX package leaves this model to XLA, so it is stock PyTorch here.
It runs where its features are (a tensor on the card), or on ``device``
for numpy features; the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from stonkgs_tpu_torch.data.artifacts import KGArtifacts
from stonkgs_tpu_torch.ops.losses import weighted_cross_entropy
from stonkgs_tpu_torch.train.finetuning import (
    encode_labels,
    get_train_test_splits,
    weighted_f1,
    write_predictions,
)

Features = Union[np.ndarray, torch.Tensor]
DROPOUT = 0.1


def build_node2vec_features(artifacts: KGArtifacts, sources, targets) -> np.ndarray:
    """(N, 2·rw_len, dim): the embeddings along the source's and the
    target's walks; a node outside the KG gives zeros."""
    out = np.zeros((len(sources), 2 * artifacts.rw_len, artifacts.dim), np.float32)
    for i, (s, t) in enumerate(zip(sources, targets)):
        for j, name in enumerate((s, t)):
            idx = artifacts.name_to_idx.get(name, -1)
            if idx >= 0:
                out[i, j * artifacts.rw_len: (j + 1) * artifacts.rw_len] = (
                    artifacts.vectors[artifacts.walk_indices[idx]])
    return out


def build_transe_features(transe_artifacts, sources, relations, targets) -> np.ndarray:
    """(N, 3, dim): head, relation and tail embeddings; unknown -> zeros."""
    out = np.zeros((len(sources), 3, transe_artifacts.dim), np.float32)
    for i, names in enumerate(zip(sources, relations, targets)):
        for j, name in enumerate(names):
            idx = transe_artifacts.name_to_idx.get(name, -1)
            if idx >= 0:
                out[i, j] = transe_artifacts.vectors[idx]
    return out


def init_params(gen: torch.Generator, d_in: int, num_classes: int) -> dict:
    """Linear layer: kernel uniform in ±1/sqrt(d_in), zero bias (fp32, CPU)."""
    bound = 1.0 / np.sqrt(d_in)
    kernel = (torch.rand(d_in, num_classes, generator=gen) * 2.0 - 1.0) * bound
    return {"kernel": kernel, "bias": torch.zeros(num_classes)}


def forward(params: dict, x: torch.Tensor, *, rng: Optional[torch.Generator] = None,
            deterministic: bool = True) -> torch.Tensor:
    """max-pool (axis 1) -> dropout -> linear -> softmax: PROBABILITIES."""
    h = x.amax(dim=1)
    if not deterministic and rng is not None:
        keep = torch.rand(h.shape, generator=rng, device=h.device) < 1.0 - DROPOUT
        h = torch.where(keep, h / (1.0 - DROPOUT), 0.0)
    return torch.softmax(h @ params["kernel"] + params["bias"], dim=-1)


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor, class_weights: torch.Tensor,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """Weighted cross entropy over the probabilities (the reference's
    double softmax), with training-mode dropout."""
    return weighted_cross_entropy(forward(params, x, rng=rng, deterministic=False), y,
                                  class_weights)


def ins_class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Inverse Number of Samples weights of the train split."""
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    return (1.0 / np.maximum(counts, 1.0)).astype(np.float32)


def _on(features: Features, device) -> torch.Tensor:
    if isinstance(features, torch.Tensor):
        return features
    return torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(device)


def train_kg_baseline(
    features: Features,         # (N, L, dim)
    labels: np.ndarray,         # (N,) int
    num_classes: int,
    *,
    epochs: int = 10,
    lr: float = 1e-3,
    batch_size: int = 16,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Train the pooled linear model; returns its parameters.  The batch
    order is the JAX package's (``default_rng(seed)`` permutations); the
    dropout masks come from a generator seeded with ``seed``."""
    x = _on(features, device)
    device = x.device
    gen = torch.Generator().manual_seed(seed)
    params = {k: v.to(device).requires_grad_(True)
              for k, v in init_params(gen, x.shape[-1], num_classes).items()}
    weights = torch.from_numpy(ins_class_weights(labels, num_classes)).to(device)
    y = torch.as_tensor(labels, dtype=torch.int64).to(device)
    opt = torch.optim.AdamW(list(params.values()), lr=lr, weight_decay=1e-4)
    dropout_rng = torch.Generator(device=device).manual_seed(seed)
    order = np.random.default_rng(seed)
    n = len(labels)
    batch_size = min(batch_size, n)
    for _ in range(epochs):
        perm = torch.from_numpy(order.permutation(n)).to(device)
        for i in range(0, n, batch_size):
            idx = perm[i: i + batch_size]
            opt.zero_grad(set_to_none=True)
            loss_fn(params, x[idx], y[idx], weights, dropout_rng).backward()
            opt.step()
    return {k: v.detach() for k, v in params.items()}


@torch.no_grad()
def predict(params: dict, features: Features, batch_size: int = 256) -> np.ndarray:
    """Predicted class ids, in batches, on the parameters' device."""
    x = _on(features, params["kernel"].device)
    out = [forward(params, x[i: i + batch_size]).argmax(dim=-1).cpu().numpy()
           for i in range(0, len(x), batch_size)]
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def run_kg_baseline_cv(
    features: Features,
    labels_str,
    *,
    epochs: int = 10,
    lr: float = 1e-3,
    batch_size: int = 16,
    cv: int = 5,
    seed: int = 42,
    logger=None,
    task_name: str = "",
    output_dir: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, float]:
    """Cross-validated weighted F1; ``output_dir`` gets
    ``predicted_labels_kg_{task}df.tsv``.  Numpy features are copied to
    ``device`` once; a tensor's own device is used."""
    x = _on(features, device)
    labels, tag2id, id2tag = encode_labels(list(labels_str))
    splits = get_train_test_splits(labels, random_seed=seed, n_splits=cv)
    f1s, rows = [], []
    for fold, idx in enumerate(splits):
        tr = torch.from_numpy(idx["train_idx"]).to(x.device)
        te = torch.from_numpy(idx["test_idx"]).to(x.device)
        params = train_kg_baseline(x[tr], labels[idx["train_idx"]], len(tag2id),
                                   epochs=epochs, lr=lr, batch_size=batch_size,
                                   seed=seed + fold)
        pred = predict(params, x[te])
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
        write_predictions(os.path.join(output_dir, f"predicted_labels_kg_{task_name}df.tsv"),
                          rows, id2tag)
    return result
