"""node2vec KG embeddings: the C++ walker, word2vec on torch, link-prediction HPO.

The port of the JAX package's ``models/node2vec.py`` (the reference's
``run_node2vec`` / ``run_node2vec_hpo``, ``node2vec.py:270-370,93-257``):
CSR random walks (walk length 127, 4 epochs, p = q = 1) -> word2vec
(dim 768, window 3, negative 5, 1 iteration, min_count 1) on ``device``
-> the two TSV artifacts that
:func:`~stonkgs_tpu_torch.data.artifacts.load_kg_artifacts` reads.

The artifact format is the reference's, its quirk included: the walks
file zips the count-sorted vocabulary with the raw walk matrix
(CSR-node-id order), so row k pairs the k-th most frequent node with the
walk that STARTED at node id k (``node2vec.py:358-370``); the
preprocessors read it as "the walk of that node".

The HPO objective is the link-prediction ROC AUC (EdgeSplitter-style
negatives, Hadamard features, a logistic regression) over (epochs,
window): optuna if importable, else the same grid in the same order.  The
stratified split, the logistic regression and the AUC are numpy
versions of scikit-learn's (a machine serving the port has no
scikit-learn): ``train_test_split(stratify=...)`` index for index, the
L2 (C = 1) regression's unique minimiser found by Newton's method in
float64, ``roc_auc_score`` by its own curve and trapezoid.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from stonkgs_tpu_torch.data.tsv_io import read_columns
from stonkgs_tpu_torch.data.walker import CSRGraph, random_walks
from stonkgs_tpu_torch.models.word2vec import Word2VecResult, train_word2vec
from stonkgs_tpu_torch.train.finetuning import _stratified_shuffle_split

logger = logging.getLogger(__name__)


def save_embeddings_tsv(result: Word2VecResult, path) -> None:
    """Count-sorted ``name\\tv0\\tv1...`` rows, each value ``repr`` of
    the float (reference ``:350-354``)."""
    with open(path, "w", encoding="utf-8") as f:
        for name, vec in zip(result.index_to_word, result.vectors.tolist()):
            f.write(str(name) + "\t" + "\t".join(map(repr, vec)) + "\n")


def save_walks_tsv(
    result: Word2VecResult, walks: np.ndarray, graph: CSRGraph, path
) -> None:
    """Reference walks format incl. the vocab/walk-row pairing quirk."""
    names = np.asarray(graph.names, dtype=object)
    with open(path, "w", encoding="utf-8") as f:
        for name, walk in zip(result.index_to_word, walks):
            f.write(str(name) + "\t" + "\t".join(names[walk]) + "\n")


def _edges(triples_df, pretraining_path, sep: str):
    """(sources, targets) of the triples: the caller's table, or the
    pre-training TSV read with names kept as the file spells them."""
    if triples_df is not None:
        return list(triples_df["source"]), list(triples_df["target"])
    cols = read_columns(pretraining_path, ("source", "target"), sep)
    return cols["source"], cols["target"]


def run_node2vec(
    triples_df=None,
    pretraining_path: Optional[str] = None,
    sep: str = "\t",
    *,
    dimensions: int = 768,
    walk_length: int = 127,
    epochs: int = 4,
    window_size: int = 3,
    negative: int = 5,
    iterations: int = 1,
    p: float = 1.0,
    q: float = 1.0,
    n_threads: Optional[int] = None,
    seed: int = 0,
    embeddings_output_path: Optional[str] = None,
    random_walks_output_path: Optional[str] = None,
    output_dir: str = ".",
    device_pipeline: bool = False,
    device="cuda",
) -> Tuple[Word2VecResult, np.ndarray, CSRGraph]:
    """Production node2vec run (reference defaults) from a table with
    ``source`` and ``target`` columns or the pre-training TSV; the SGNS
    tables live on ``device``."""
    sources, targets = _edges(triples_df, pretraining_path, sep)
    logger.info("%d node embeddings are expected", len(set(sources) | set(targets)))
    graph = CSRGraph.from_edges(sources, targets, directed=False)
    walks = random_walks(graph, walk_len=walk_length, epochs=epochs, seed=seed, p=p, q=q,
                         n_threads=n_threads)
    result = train_word2vec(
        walks, graph.n_nodes, dim=dimensions, window=window_size, negative=negative,
        iterations=iterations, seed=seed, index_to_name=graph.names,
        device_pipeline=device_pipeline, device=device)
    logger.info("%d embeddings were learned", len(result.index_to_word))
    if embeddings_output_path is None:
        embeddings_output_path = os.path.join(output_dir, "embeddings_best_model.tsv")
    if random_walks_output_path is None:
        random_walks_output_path = os.path.join(output_dir, "random_walks_best_model.tsv")
    save_embeddings_tsv(result, embeddings_output_path)
    save_walks_tsv(result, walks, graph, random_walks_output_path)
    return result, walks, graph


# ---------------------------------------------------------------------------
# link prediction + HPO
# ---------------------------------------------------------------------------

def split_edges_for_link_prediction(
    graph: CSRGraph, frac: float = 0.1, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """EdgeSplitter-style (positive, negative) edge sample.

    Samples ``frac`` of the edges as positives and an equal number of
    uniformly random non-edges as negatives.  Returns (pairs (M, 2) node
    ids, labels (M,))."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(graph.n_nodes),
                     np.diff(graph.indptr).astype(np.int64))
    edges = np.stack([rows, graph.indices], axis=1)
    edges = edges[edges[:, 0] < edges[:, 1]]  # undirected dedup
    k = max(int(len(edges) * frac), 1)
    pos = edges[rng.choice(len(edges), k, replace=False)]

    edge_set = set(map(tuple, edges.tolist()))
    neg = []
    # bounded sampling: a small/dense graph may have fewer than k distinct
    # non-edges — take what exists instead of spinning forever
    attempts = 0
    max_attempts = 100 * k + 1000
    while len(neg) < k and attempts < max_attempts:
        a = rng.integers(0, graph.n_nodes, k)
        b = rng.integers(0, graph.n_nodes, k)
        attempts += k
        for u, v in zip(a, b):
            if u == v:
                continue
            key = (min(int(u), int(v)), max(int(u), int(v)))
            if key not in edge_set:
                neg.append(key)
            if len(neg) == k:
                break
    if len(neg) < k:
        if not neg:
            raise ValueError(
                "graph has no non-edges to sample — link prediction is "
                "undefined on a complete graph")
        logger.warning(
            "only %d of %d negative samples found (dense graph); "
            "truncating positives to match", len(neg), k)
        k = len(neg)
        pos = pos[:k]
    pairs = np.concatenate([pos, np.asarray(neg)], axis=0)
    labels = np.concatenate([np.ones(k), np.zeros(k)])
    return pairs, labels


def _train_test_split(labels: np.ndarray, seed: int,
                      test_size: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """The indices of ``train_test_split(..., stratify=labels,
    random_state=seed)``: ceil(test_size * n) test rows."""
    n_test = math.ceil(test_size * len(labels))
    return _stratified_shuffle_split(labels, len(labels) - n_test, n_test, seed)


def _log1pexp(z: np.ndarray) -> np.ndarray:
    return np.logaddexp(0.0, z)


def _fit_logistic(x: np.ndarray, y: np.ndarray, C: float = 1.0,
                  max_iter: int = 100) -> Tuple[np.ndarray, float]:
    """(coef, intercept) of ``LogisticRegression(C=C)`` (L2 penalty, the
    intercept unpenalised): the unique minimiser of sum(log-loss) +
    |coef|^2 / (2C), by Newton's method with a backtracking line search
    in float64, to convergence."""
    X = np.concatenate([np.asarray(x, np.float64), np.ones((len(x), 1))], axis=1)
    y = np.asarray(y, np.float64)
    reg = np.full(X.shape[1], 1.0 / C)
    reg[-1] = 0.0

    def objective(w):
        z = X @ w
        return float(np.sum(_log1pexp(z) - y * z) + 0.5 * np.sum(reg * w * w))

    w = np.zeros(X.shape[1])
    f = objective(w)
    for _ in range(max_iter):
        p = np.exp(-_log1pexp(-(X @ w)))                   # sigmoid, no overflow
        grad = X.T @ (p - y) + reg * w
        hess = (X * (p * (1.0 - p))[:, None]).T @ X + np.diag(reg)
        step = np.linalg.solve(hess, grad)
        decrement = float(grad @ step)
        if decrement <= 1e-20 * max(1.0, abs(f)):
            break
        t = 1.0
        while True:
            w_new = w - t * step
            f_new = objective(w_new)
            if f_new <= f - 1e-4 * t * decrement or t < 1e-12:
                break
            t *= 0.5
        w, f = w_new, f_new
    return w[:-1], float(w[-1])


def _roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """``roc_auc_score`` of a binary task: the ROC curve at each distinct
    score (collinear points dropped, (0, 0) prepended) and its
    trapezoidal area, as scikit-learn computes them."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order].astype(np.float64)
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                              True])[0]
        fps, tps = fps[keep], tps[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    if fps[-1] <= 0 or tps[-1] <= 0:
        raise ValueError("Only one class is present in y_true. ROC AUC score is not "
                         "defined in that case.")
    tpr, fpr = tps / tps[-1], fps / fps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())   # numpy's trapezoid


def run_link_prediction(
    graph: CSRGraph, result: Word2VecResult, seed: int = 0, frac: float = 0.1
) -> float:
    """Hadamard features + logistic regression ROC AUC on its hard
    predictions (reference ``:34-71``)."""
    name_to_row = {n: i for i, n in enumerate(result.index_to_word)}
    row = np.fromiter((name_to_row[n] for n in graph.names), np.int64, graph.n_nodes)
    pairs, labels = split_edges_for_link_prediction(graph, frac=frac, seed=seed)
    feats = result.vectors[row[pairs[:, 0]]] * result.vectors[row[pairs[:, 1]]]
    tr, te = _train_test_split(labels, seed)
    coef, intercept = _fit_logistic(feats[tr], labels[tr])
    pred = (feats[te].astype(np.float64) @ coef + intercept > 0).astype(np.float64)
    return _roc_auc(labels[te], pred)


def run_node2vec_hpo(
    triples_df=None,
    pretraining_path: Optional[str] = None,
    sep: str = "\t",
    *,
    n_trials: int = 1,
    seed: int = 0,
    dimensions: int = 768,
    walk_length: int = 127,
    output_dir: str = ".",
    embeddings_output_path: Optional[str] = None,
    random_walks_output_path: Optional[str] = None,
    logger_fn=None,
    device="cuda",
) -> Dict:
    """HPO over (epochs in {2,4,8}, window in [3,5]) maximizing link-pred AUC.

    Uses optuna when available; otherwise a deterministic sweep over the
    same space, in the same order."""
    sources, targets = _edges(triples_df, pretraining_path, sep)
    graph = CSRGraph.from_edges(sources, targets)
    trials = []

    def evaluate(epochs: int, window: int) -> float:
        walks = random_walks(graph, walk_len=walk_length, epochs=epochs, seed=seed)
        result = train_word2vec(
            walks, graph.n_nodes, dim=dimensions, window=window, negative=5,
            iterations=1, seed=seed, index_to_name=graph.names, device=device)
        auc = run_link_prediction(graph, result, seed=seed)
        trials.append({"epochs": epochs, "window": window, "auc": auc,
                       "result": result, "walks": walks})
        if logger_fn:
            logger_fn({"epochs": epochs, "window": window, "auc": auc})
        return auc

    try:
        import optuna
    except ImportError:
        optuna = None
    if optuna is not None:
        def objective(trial):
            return evaluate(trial.suggest_categorical("epochs", [2, 4, 8]),
                            trial.suggest_int("window_size", 3, 5))

        optuna.create_study(direction="maximize").optimize(objective, n_trials=n_trials)
    else:
        space = [(e, w) for e in (2, 4, 8) for w in (3, 4, 5)]
        for epochs, window in space[:n_trials]:
            evaluate(epochs, window)

    best = max(trials, key=lambda t: t["auc"])
    if embeddings_output_path is None:
        embeddings_output_path = os.path.join(output_dir, "embeddings_best_model.tsv")
    if random_walks_output_path is None:
        random_walks_output_path = os.path.join(output_dir, "random_walks_best_model.tsv")
    save_embeddings_tsv(best["result"], embeddings_output_path)
    save_walks_tsv(best["result"], best["walks"], graph, random_walks_output_path)
    return {"best_auc": best["auc"], "best_params":
            {"epochs": best["epochs"], "window": best["window"]},
            "n_trials": len(trials)}
