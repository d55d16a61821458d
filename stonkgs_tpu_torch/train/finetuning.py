"""Fine-tuning of the port: cross-validated sequence classification.

The port of the JAX package's ``stonkgs_tpu/train/finetuning.py`` for one
device: deterministic seed-42 splits (a stratified subsample above
``max_dataset_size``, then a shuffled 5-fold split), per-fold training
from the pre-trained parameters with a fresh classifier head, weighted-F1
evaluation and the predicted-label TSV.  A fold trains with
:func:`~stonkgs_tpu_torch.train.pretraining.make_train_step` and the
classification loss, on the parameters' device.

The splits and the F1 are numpy versions of scikit-learn's ``KFold``,
``StratifiedShuffleSplit`` and ``f1_score(average="weighted")``, index for
index and value for value (a machine serving the port needs only torch and
numpy); the TSV is written without pandas, byte for byte as
``DataFrame.to_csv(sep="\\t", index=False)`` writes it.

With a ``mesh`` (every rank calls with the same arguments) a fold trains
as the JAX package's does on its mesh (``finetuning.py:145-178``): the
parameters split by :func:`~stonkgs_tpu_torch.parallel.mesh.shard_params`
without FSDP, the KG gather over the model axis, each rank on its rows of
every batch; the evaluation runs on the gathered parameters, and the main
rank alone writes the TSV and the exported model.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
from collections import Counter
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from stonkgs_tpu_torch.config import STonKGsConfig
from stonkgs_tpu_torch.models import stonkgs
from stonkgs_tpu_torch.models.heads import init_classifier_head
from stonkgs_tpu_torch.parallel.mesh import shard_batch, shard_params
from stonkgs_tpu_torch.train.optimizer import AdamW, merge_frozen, split_frozen
from stonkgs_tpu_torch.train.pretraining import (
    TrainState,
    _prefetch_to_device,
    data_iterator,
    init_train_state,
    make_train_step,
    resolve_train_impl,
    to_device,
)
from stonkgs_tpu_torch.utils.batching import batched_apply
from stonkgs_tpu_torch.utils.convert import params_to
from stonkgs_tpu_torch.utils.hf_export import save_pretrained
from stonkgs_tpu_torch.utils.logging import RunLogger
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

BATCH_KEYS = ("input_ids", "attention_mask", "token_type_ids")


# ---------------------------------------------------------------------------
# splits and metric (scikit-learn's, in numpy)
# ---------------------------------------------------------------------------

def _kfold(n: int, n_splits: int, seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``KFold(n_splits, shuffle=True, random_state=seed).split``: one
    ``RandomState(seed).shuffle`` of 0..n-1, folds of ``n // n_splits``
    with the first ``n % n_splits`` one larger; both index sets ascending."""
    if n_splits < 2:
        raise ValueError(f"k-fold cross-validation needs n_splits >= 2, got {n_splits}")
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater "
                         f"than the number of samples: n_samples={n}.")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start: start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``utils.extmath._approximate_mode``: per-class draws
    by floored proportion, the rest by largest remainder, ties broken by
    ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle_split(labels: np.ndarray, n_train: int, n_test: int,
                              seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (train, test) indices of ``StratifiedShuffleSplit(n_splits=1,
    train_size=n_train, test_size=n_test, random_state=seed)``, in its
    order: per-class counts for the train and then the test part, one
    permutation per class (classes in sorted order, members by a stable
    argsort), then one of the train and one of the test indices."""
    classes, y_idx, counts = np.unique(labels, return_inverse=True, return_counts=True)
    if counts.min() < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is "
                         f"too few: {classes[counts < 2].tolist()}")
    if min(n_train, n_test) < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) parts must each be at "
                         f"least the number of classes ({len(classes)})")
    members = np.split(np.argsort(y_idx, kind="stable"), np.cumsum(counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(counts, n_train, rng)
    t_i = _approximate_mode(counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = members[i].take(rng.permutation(counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _stratified_subsample(labels: np.ndarray, n_train: int, seed: int) -> np.ndarray:
    """The train indices of ``StratifiedShuffleSplit(n_splits=1,
    train_size=n_train, random_state=seed)``, in its order."""
    return _stratified_shuffle_split(labels, n_train, len(labels) - n_train, seed)[0]


def get_train_test_splits(
    labels: np.ndarray,
    random_seed: int = 42,
    n_splits: int = 5,
    max_dataset_size: int = 100_000,
) -> List[Dict[str, np.ndarray]]:
    """Deterministic CV indices (``stonkgs_tpu/train/finetuning.py:38-68``).

    Above ``max_dataset_size`` rows, a stratified subsample of that size
    first; then a shuffled (not stratified) k-fold split.  ``n_splits=1``
    returns the first of 5 folds."""
    labels = np.asarray(labels)
    idx = np.arange(len(labels))
    if len(labels) > max_dataset_size:
        idx = idx[_stratified_subsample(labels, max_dataset_size, random_seed)]
    folds = [{"train_idx": idx[tr], "test_idx": idx[te]}
             for tr, te in _kfold(len(idx), 5 if n_splits == 1 else n_splits, random_seed)]
    return folds[:1] if n_splits == 1 else folds


def weighted_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """scikit-learn's ``f1_score(average="weighted")``: classes are the
    sorted union of both arrays, each class's F1 = 2·tp / (2·tp + fp + fn)
    (0 where that is 0/0), weighted by its support in ``y_true``."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    classes = np.union1d(y_true, y_pred)
    t, p = np.searchsorted(classes, y_true), np.searchsorted(classes, y_pred)
    k = len(classes)
    tp = np.bincount(t[t == p], minlength=k).astype(np.float64)
    true_sum = np.bincount(t, minlength=k).astype(np.float64)
    denom = true_sum + np.bincount(p, minlength=k)
    f1 = np.divide(2.0 * tp, denom, out=np.zeros(k), where=denom > 0)
    if true_sum.sum() == 0:
        return 0.0
    return float(np.average(f1, weights=true_sum))


# ---------------------------------------------------------------------------
# training and evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FinetuneConfig:
    """The run configuration, with the JAX package's defaults (the
    reference CLI's).  ``remat`` and ``attention_impl`` go through
    :func:`~stonkgs_tpu_torch.train.pretraining.resolve_train_impl`."""

    epochs: int = 5
    lr: float = 5e-5
    batch_size: int = 8
    gradient_accumulation: int = 1
    cv: int = 5
    max_dataset_size: int = 100_000
    max_grad_norm: Optional[float] = 1.0
    seed: int = 42
    compute_dtype: str = "bfloat16"
    eval_batch_size: int = 64
    remat: str = "auto"
    attention_impl: str = "auto"


def encode_labels(labels_str) -> Tuple[np.ndarray, dict, dict]:
    """String labels -> ints, the classes numbered in ``set()`` order (as
    the reference, so the numbering follows ``PYTHONHASHSEED``)."""
    tag2id = {label: number for number, label in enumerate(set(labels_str))}
    id2tag = {v: k for k, v in tag2id.items()}
    return np.array([tag2id[x] for x in labels_str], np.int64), tag2id, id2tag


def _device(params: dict) -> torch.device:
    return tree_leaves(params)[0].device


def train_classifier(
    cfg: STonKGsConfig,
    pretrained_params: dict,
    train_features: Dict[str, np.ndarray],
    run_cfg: FinetuneConfig,
    *,
    mesh=None,
    rng_seed: int = 0,
    loss_fn: Optional[Callable] = None,
    trunk_cfg=None,
) -> Tuple[TrainState, Dict[str, float]]:
    """Train a fresh classifier head and the trunk on preprocessed
    features, on the parameters' device; returns the state and the last
    step's metrics as floats.

    The trainable subtree is copied first (the step updates in place, and
    every fold starts from ``pretrained_params``, which stay unchanged);
    the frozen backbones are shared.  ``loss_fn`` defaults to the STonKGs
    classification loss; pass ``protstonkgs.classification_loss`` for the
    tri-modality variant, with ``trunk_cfg`` (the config holding its
    hidden size) for the head.

    With a ``mesh`` the returned state holds this rank's slices and their
    layout (``state.layout.gather(state.params)`` makes them whole)."""
    remat, _ = resolve_train_impl(run_cfg.remat, run_cfg.attention_impl, mesh)
    n = len(train_features["input_ids"])
    # folds smaller than one (accumulated) batch still train: accumulation
    # shrinks first, so the micro-batch never exceeds the configured one;
    # only a fold smaller than one micro-batch trains on a smaller batch
    batch_size, accumulation = run_cfg.batch_size, run_cfg.gradient_accumulation
    if n < batch_size * accumulation:
        batch_size = min(batch_size, n)
        accumulation = max(n // batch_size, 1)
    total_steps = max(n // (batch_size * accumulation), 1) * run_cfg.epochs

    train, frozen = split_frozen(pretrained_params)
    device = _device(train)
    train = {k: tree_map(lambda t: t.detach().clone(), v)
             for k, v in train.items() if k != "classifier"}
    train["classifier"] = params_to(init_classifier_head(
        torch.Generator().manual_seed(rng_seed + 1),
        trunk_cfg if trunk_cfg is not None else cfg.bert, cfg.num_labels), device)
    tx = AdamW(learning_rate=run_cfg.lr, total_steps=total_steps,
               max_grad_norm=run_cfg.max_grad_norm)
    params, layout = merge_frozen(train, frozen), None
    place = lambda b: to_device(b, device)  # noqa: E731
    if mesh is not None:
        mesh.require_groups()
        params, layout = shard_params(params, mesh)
        place = lambda b: to_device(shard_batch(b, mesh, accumulation), device)  # noqa: E731
    state = init_train_state(params, tx, seed=rng_seed, layout=layout)
    step_fn = make_train_step(
        cfg, tx, loss_fn=loss_fn if loss_fn is not None else stonkgs.classification_loss,
        compute_dtype=getattr(torch, run_cfg.compute_dtype),
        grad_accumulation_steps=accumulation, remat=remat, mesh=mesh)
    batches = _prefetch_to_device(
        data_iterator(train_features, batch_size * accumulation, seed=rng_seed),
        place, total_steps)
    metrics = {}
    try:
        for batch in batches:
            state, metrics = step_fn(state, batch)
    finally:
        batches.close()
    return state, {k: float(v) for k, v in metrics.items()}


def predict(
    cfg: STonKGsConfig,
    params: dict,
    features: Dict[str, np.ndarray],
    *,
    batch_size: int = 64,
    compute_dtype: torch.dtype = torch.bfloat16,
    logits_fn: Optional[Callable] = None,
) -> np.ndarray:
    """Classification logits over a feature set, (N, num_labels) fp32, in
    padded batches on the parameters' device."""
    fn = logits_fn if logits_fn is not None else stonkgs.classification_logits
    return batched_apply(lambda chunk: fn(params, cfg, chunk, compute_dtype=compute_dtype),
                         features, BATCH_KEYS, batch_size, _device(params))


def write_predictions(path: str, rows, id2tag: dict) -> None:
    """The per-fold predicted-label TSV (split, index, predicted_label,
    true_label), as ``DataFrame.to_csv(path, sep="\\t", index=False)``
    writes it (pandas writes through the same ``csv`` writer)."""
    with open(path, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(["split", "index", "predicted_label", "true_label"])
        for fold, te, pred, true in rows:
            writer.writerows([fold, i, id2tag[p], id2tag[t]]
                             for i, p, t in zip(te.tolist(), pred.tolist(), true.tolist()))


def run_sequence_classification_cv(
    features: Dict[str, np.ndarray],
    labels_str,
    pretrained_params: dict,
    cfg: STonKGsConfig,
    run_cfg: Optional[FinetuneConfig] = None,
    *,
    task_name: str = "",
    output_dir: Optional[str] = None,
    logger: Optional[RunLogger] = None,
    mesh=None,
    loss_fn: Optional[Callable] = None,
    logits_fn: Optional[Callable] = None,
    trunk_cfg=None,
) -> Dict[str, float]:
    """Cross-validated fine-tuning; returns the mean and std weighted F1.

    ``features`` come from ``data.preprocessing.preprocess_for_finetuning``
    (or its TransE and ProtSTonKGs counterparts); ``loss_fn``,
    ``logits_fn`` and ``trunk_cfg`` select ProtSTonKGs.  With
    ``output_dir``: the TSV ``predicted_labels_stonkgs_{task}df.tsv`` and,
    for the STonKGs family, the last fold's model as an HF checkpoint in
    ``{output_dir}/{task or "model"}``."""
    run_cfg = run_cfg or FinetuneConfig()
    labels, tag2id, id2tag = encode_labels(list(labels_str))
    cfg = cfg.replace(num_labels=len(tag2id))
    splits = get_train_test_splits(labels, random_seed=run_cfg.seed, n_splits=run_cfg.cv,
                                   max_dataset_size=run_cfg.max_dataset_size)
    f1_scores, rows, state = [], [], None
    for fold, indices in enumerate(splits):
        tr, te = indices["train_idx"], indices["test_idx"]
        train_feats = {k: v[tr] for k, v in features.items() if k != "labels"}
        train_feats["labels"] = labels[tr]
        state, _ = train_classifier(cfg, pretrained_params, train_feats, run_cfg,
                                    mesh=mesh, rng_seed=run_cfg.seed + fold,
                                    loss_fn=loss_fn, trunk_cfg=trunk_cfg)
        if state.layout is not None:   # the evaluation and export read whole leaves
            state = dataclasses.replace(state, params=state.layout.gather(state.params),
                                        layout=None)
        logits = predict(cfg, state.params, {k: v[te] for k, v in features.items()
                                             if k != "labels"},
                         batch_size=run_cfg.eval_batch_size,
                         compute_dtype=getattr(torch, run_cfg.compute_dtype),
                         logits_fn=logits_fn)
        pred = logits.argmax(axis=1)
        f1 = weighted_f1(labels[te], pred)
        f1_scores.append(f1)
        rows.append((fold, te, pred, labels[te]))
        if logger:
            logger.log_param("label dict", str(tag2id))
            logger.log_param("training dataset size", len(tr))
            logger.log_param("training class dist", str(Counter(labels[tr].tolist())))
            logger.log_param("test dataset size", len(te))
            logger.log_metric("f1_score_weighted", f1, step=fold)

    result = {"f1_score_mean": float(np.mean(f1_scores)),
              "f1_score_std": float(np.std(f1_scores))}
    if logger:
        logger.log_param("task name", task_name)
        logger.log_metrics(result)
    if output_dir and (mesh is None or mesh.is_main):
        os.makedirs(output_dir, exist_ok=True)
        write_predictions(os.path.join(output_dir,
                                       f"predicted_labels_stonkgs_{task_name}df.tsv"),
                          rows, id2tag)
        # the last fold's model, as the reference's ``trainer.save_model``;
        # only the STonKGs family has an exporter, and the export is
        # best-effort, as in the JAX package
        if state is not None and trunk_cfg is None:
            try:
                save_pretrained(state.params, cfg,
                                os.path.join(output_dir, task_name or "model"))
            except (OSError, KeyError, ValueError) as e:
                logging.getLogger(__name__).warning(
                    "could not export fine-tuned model: %s", e)
    return result
