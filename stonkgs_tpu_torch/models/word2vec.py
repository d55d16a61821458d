"""Word2vec (skip-gram / CBOW with negative sampling) on torch tensors.

The port of the JAX package's ``models/word2vec.py``, which replaces
gensim's C kernels in the node2vec pipeline (the reference's
``node2vec.py:314-334``: dim 768, window 3, negative 5, iter 1,
min_count 1, sample default).  Gensim's semantics at the algorithm level:
count-sorted vocabulary, unigram^0.75 negatives, dynamic (reduced)
windows, subsampling, a linear learning-rate decay.  Both tables are fp32
on an explicit ``device`` and are updated in place.

Two pipelines share the vocabulary, subsampling and negative
distributions (numpy) and the update (torch):

* host pipeline (the default): pairs are made in numpy on the host, an
  iteration at a time, and consume ``np.random.default_rng(seed)`` in the
  JAX package's order (per iteration the keep draws, the reduced windows,
  then one permutation; one ``rng.random((n, negative))`` per batch), so
  its pairs and negatives are the JAX package's; each batch goes to the
  card through :func:`~stonkgs_tpu_torch.utils.batching.host_to_device`;
* device pipeline (``device_pipeline=True``): the ranked walk corpus and
  each iteration's row permutation stay on the device, and a slab of rows
  at a time becomes a static (center, context, mask) layout over every
  (position, offset, direction) slot; keeps, reduced windows and Vose
  alias negatives are drawn there by a ``torch.Generator`` seeded from
  (seed, iteration, slab), so the result does not depend on how slabs are
  queued.  Masked slots contribute nothing (masked scatter-mean).

Every random function is split into a draw and a computation from the
draws, so tests can feed the JAX package's draws into the computation.
``jax.random`` itself is not reproduced: the initial ``syn0`` comes from
:func:`_init_syn0` alone, which tests replace.

Each update takes every gather from both tables before either is
updated, as the functional JAX code does.  The scatter-adds are
``index_add_``: on a card they are atomic, so two card runs differ in the
last bits; on the CPU they add in index order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from stonkgs_tpu_torch.utils.batching import host_to_device

F32 = torch.float32


@dataclasses.dataclass
class Word2VecResult:
    """Trained skip-gram embeddings + vocabulary (count-sorted)."""
    vectors: np.ndarray          # (V, dim) input embeddings, count-sorted rows
    index_to_word: List         # row -> token (count-desc order, gensim-style)
    counts: np.ndarray           # (V,) corpus counts in row order


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("word2vec on 'cuda' needs a CUDA device; pass device='cpu' "
                           "to train on the CPU")
    return device


def _build_vocab(corpus: np.ndarray, n_tokens: int):
    """Counts + count-desc ordering (stable), gensim-style."""
    counts = np.bincount(corpus.reshape(-1), minlength=n_tokens)
    order = np.argsort(-counts, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return counts, order, rank


def _keep_probabilities(counts_sorted: np.ndarray, sample: float) -> Optional[np.ndarray]:
    """gensim's subsampling keep probability per rank (None: keep all)."""
    if not sample or sample <= 0:
        return None
    total = counts_sorted.sum()
    thresh = sample * total
    with np.errstate(divide="ignore", invalid="ignore"):
        kp = (np.sqrt(counts_sorted / thresh) + 1) * (thresh / np.maximum(counts_sorted, 1))
    return np.clip(kp, 0, 1).astype(np.float32)


def _negative_probabilities(counts_sorted: np.ndarray) -> np.ndarray:
    """The negative-sampling distribution, count^0.75 normalised (float64)."""
    neg_probs = counts_sorted.astype(np.float64) ** 0.75
    return neg_probs / neg_probs.sum()


def _init_syn0(V: int, dim: int, seed: int, device) -> torch.Tensor:
    """The initial input table: uniform in [-0.5, 0.5) / dim, fp32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand((V, dim), generator=gen, device=device, dtype=F32) - 0.5) / dim


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------

def _scatter_mean_add(table: torch.Tensor, idx: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """table[idx] += grads / (occurrences of idx in the batch), in place.

    Batched SGD stays stable when the same row appears many times in one
    batch (a raw scatter-add would multiply the lr by the occurrence
    count and diverge on hot nodes).  Only a (V,) count vector is made,
    never a (V, D) temporary."""
    counts = torch.zeros(table.shape[0], dtype=F32, device=table.device)
    counts.index_add_(0, idx, torch.ones(idx.shape, dtype=F32, device=table.device))
    return table.index_add_(0, idx, grads / counts.index_select(0, idx).clamp_min_(1.0)[:, None])


def _masked_scatter_mean_add(table: torch.Tensor, idx: torch.Tensor, grads: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """:func:`_scatter_mean_add` where each contribution carries a 0/1
    weight: a masked-out entry adds nothing to the update and nothing to
    its row's count, so a masked batch updates exactly like the compacted
    batch of its survivors."""
    counts = torch.zeros(table.shape[0], dtype=F32, device=table.device)
    counts.index_add_(0, idx, weights)
    scale = weights / counts.index_select(0, idx).clamp_min_(1.0)
    return table.index_add_(0, idx, grads * scale[:, None])


def _targets_and_grads(v: torch.Tensor, syn1: torch.Tensor, positives: torch.Tensor,
                       negatives: torch.Tensor, lr: float):
    """Shared half of both steps: the (B, 1+K) targets, their rows u of
    syn1 (gathered now, before any update) and the scaled gradient g of
    the log-likelihood w.r.t. the logits (label 1 for the positive)."""
    B, K = negatives.shape
    targets = torch.cat([positives[:, None], negatives], dim=1)          # (B, 1+K)
    u = syn1.index_select(0, targets.reshape(-1)).view(B, 1 + K, -1)     # (B, 1+K, D)
    g = torch.bmm(u, v[:, :, None]).squeeze(-1).sigmoid_().neg_()        # 0 - sigmoid
    g[:, 0] += 1.0                                                        # 1 - sigmoid
    return targets, u, g.mul_(lr)


def _sgd_core(syn0: torch.Tensor, syn1: torch.Tensor, centers: torch.Tensor,
              contexts: torch.Tensor, negatives: torch.Tensor, lr: float,
              mask: Optional[torch.Tensor] = None):
    """One batched skip-gram negative-sampling update of both tables, in
    place: centers (B,), contexts (B,), negatives (B, K); input = center,
    targets = context (+) and negatives (-).  ``mask`` (B,) float 0/1
    drops pair slots exactly (the device pipeline's static layout)."""
    B, K = negatives.shape
    v = syn0.index_select(0, centers)                                    # (B, D)
    targets, u, g = _targets_and_grads(v, syn1, contexts, negatives, lr)
    dv = torch.bmm(g[:, None, :], u).squeeze(1)                          # (B, D)
    du = (g[:, :, None] * v[:, None, :]).view(B * (1 + K), -1)
    del u, v
    flat = targets.reshape(-1)
    if mask is None:
        _scatter_mean_add(syn0, centers, dv)
        _scatter_mean_add(syn1, flat, du)
    else:
        _masked_scatter_mean_add(syn0, centers, dv, mask)
        _masked_scatter_mean_add(syn1, flat, du, mask[:, None].expand(B, 1 + K).reshape(-1))
    return syn0, syn1


def _cbow_step(syn0: torch.Tensor, syn1: torch.Tensor, contexts: torch.Tensor,
               context_mask: torch.Tensor, targets_pos: torch.Tensor,
               negatives: torch.Tensor, lr: float):
    """CBOW update in place: input = mean of the (B, C) context vectors
    under ``context_mask``, target = the center word."""
    B, K = negatives.shape
    C = contexts.shape[1]
    cw = context_mask.to(F32)                                            # (B, C)
    denom = cw.sum(dim=1, keepdim=True).clamp_min_(1.0)
    ctx = syn0.index_select(0, contexts.reshape(-1)).view(B, C, -1)
    v = torch.bmm(cw[:, None, :], ctx).squeeze(1) / denom                # (B, D)
    del ctx
    targets, u, g = _targets_and_grads(v, syn1, targets_pos, negatives, lr)
    dv = torch.bmm(g[:, None, :], u).squeeze(1) / denom
    du = (g[:, :, None] * v[:, None, :]).view(B * (1 + K), -1)
    del u, v
    _scatter_mean_add(syn0, contexts.reshape(-1),
                      (dv[:, None, :] * cw[:, :, None]).view(B * C, -1))
    _scatter_mean_add(syn1, targets.reshape(-1), du)
    return syn0, syn1


# ---------------------------------------------------------------------------
# host pipeline: pairs in numpy
# ---------------------------------------------------------------------------

def _make_pairs(
    sentences: np.ndarray,   # (R, L) int32 of vocab-rank ids
    window: int,
    rng: np.random.Generator,
    keep_prob: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) pairs with gensim dynamic windows + subsampling."""
    R, L = sentences.shape
    if keep_prob is not None:
        keep = rng.random(sentences.shape) < keep_prob[sentences]
    else:
        keep = np.ones(sentences.shape, bool)
    centers, contexts = [], []
    reduced = rng.integers(0, window, (R, L))
    eff = window - reduced                      # effective window per pos
    for off in range(1, window + 1):
        valid = (eff[:, :-off] >= off) & keep[:, :-off] & keep[:, off:]
        r, c = np.nonzero(valid)
        a = sentences[r, c]
        b = sentences[r, c + off]
        # symmetric pairs (center->context both directions, like gensim sg)
        centers.append(a)
        contexts.append(b)
        centers.append(b)
        contexts.append(a)
    return np.concatenate(centers), np.concatenate(contexts)


def _train_host(syn0, syn1, corpus_ranked, keep_prob, neg_probs, rng, *, window, negative,
                iterations, alpha, min_alpha, batch_pairs, sg):
    """The host pipeline: an iteration's pairs and their permutation on
    the host, then one (B, 2 + negative) int32 batch a step to the
    tables' device."""
    neg_cum = np.cumsum(neg_probs)
    pair_batches = []
    for _ in range(iterations):
        c, x = _make_pairs(corpus_ranked, window, rng, keep_prob)
        perm = rng.permutation(len(c))
        pair_batches.append((c[perm], x[perm]))
    total_pairs = sum(len(c) for c, _ in pair_batches)
    if batch_pairs is None:
        # segment-mean updates learn per BATCH, not per occurrence: size
        # batches so the run makes >= ~2000 update steps regardless of
        # corpus size (capped at 64k pairs/step for device efficiency)
        batch_pairs = int(min(1 << 16, max(128, total_pairs // 2000)))

    done = 0
    for c_all, x_all in pair_batches:
        for i in range(0, len(c_all), batch_pairs):
            c = c_all[i: i + batch_pairs]
            batch = np.empty((len(c), 2 + negative), np.int32)
            batch[:, 0] = c
            batch[:, 1] = x_all[i: i + batch_pairs]
            batch[:, 2:] = np.searchsorted(neg_cum, rng.random((len(c), negative)))
            lr = float(np.float32(alpha - (alpha - min_alpha) * (done / max(total_pairs, 1))))
            b = host_to_device(batch, syn0.device)
            if sg:
                _sgd_core(syn0, syn1, b[:, 0], b[:, 1], b[:, 2:], lr)
            else:
                # CBOW on consecutive pairs degenerates to sg with C=1 here
                _cbow_step(syn0, syn1, b[:, 1:2], torch.ones((len(c), 1), device=syn0.device),
                           b[:, 0], b[:, 2:], lr)
            done += len(c)


# ---------------------------------------------------------------------------
# device pipeline: static pair slabs, draws on the device
# ---------------------------------------------------------------------------

def _pair_slots_per_row(L: int, window: int) -> int:
    """Static potential-pair slots per corpus row in the device layout."""
    return 2 * window * L


def _slab_draws(toks: torch.Tensor, keep_prob: torch.Tensor, window: int,
                gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """A slab's random half: the subsampling keeps (bool) and the
    reduced windows in [0, window), each (Rb, L)."""
    keep = torch.rand(toks.shape, generator=gen, device=toks.device) < keep_prob[toks]
    red = torch.randint(0, window, toks.shape, generator=gen, device=toks.device,
                        dtype=torch.int32)
    return keep, red


def _device_pair_slab(toks: torch.Tensor, row_valid: torch.Tensor, keep: torch.Tensor,
                      red: torch.Tensor, window: int):
    """Static (centers, contexts, mask) pair layout for one row slab.

    Every (offset, direction, position) slot of the slab is one pair
    slot, laid out as the JAX package lays them out; ``mask`` keeps
    exactly the pairs :func:`_make_pairs` would emit from the same keeps
    and reduced windows (the LEFT token's effective window gates both
    directions) and drops padded rows.  Right neighbours come from a roll;
    wrapped slots are masked off."""
    Rb, L = toks.shape
    eff = window - red
    col = torch.arange(L, device=toks.device)[None, :]
    cs, xs, ms = [], [], []
    for off in range(1, window + 1):
        b = torch.roll(toks, -off, dims=1)
        m = ((col < L - off) & (eff >= off) & keep & torch.roll(keep, -off, dims=1)
             & row_valid[:, None])
        cs += [toks, b]
        xs += [b, toks]
        ms += [m, m]
    return (torch.cat(cs).reshape(-1), torch.cat(xs).reshape(-1),
            torch.cat(ms).reshape(-1).to(F32))


def _build_alias(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias tables for O(1)-per-draw sampling of ``probs``.

    Returns ``(alias, thresh)``: draw a uniform cell ``i`` in [0, V) and a
    uniform ``u`` in [0, 1); the sample is ``i`` if ``u < thresh[i]`` else
    ``alias[i]``.  Exact: each cell carries 1/V total mass split between
    its own index and one alias."""
    probs = np.asarray(probs, np.float64)
    V = len(probs)
    scaled = probs * V
    alias = np.arange(V, dtype=np.int32)
    thresh = np.ones(V, np.float32)
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        big = large.pop()
        thresh[s] = scaled[s]
        alias[s] = big
        scaled[big] = (scaled[big] + scaled[s]) - 1.0
        (small if scaled[big] < 1.0 else large).append(big)
    return alias, thresh


def _negative_draws(n: int, negative: int, V: int, gen: torch.Generator,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The alias method's random half: (n, negative) cells and uniforms."""
    cell = torch.randint(0, V, (n, negative), generator=gen, device=device, dtype=torch.int32)
    u = torch.rand((n, negative), generator=gen, device=device)
    return cell, u


def _alias_negatives(cell: torch.Tensor, u: torch.Tensor, alias: torch.Tensor,
                     thresh: torch.Tensor) -> torch.Tensor:
    """Negatives from the draws: the cell if ``u < thresh[cell]``, else
    its alias."""
    return torch.where(u < thresh[cell], cell, alias[cell])


def _slab_seed(seed: int, iteration: int, slab: int) -> int:
    """The seed of one slab's generator, from (seed, iteration, slab)."""
    return (seed * 0x9E3779B97F4A7C15 + iteration * 0xD1B54A32D192ED03 + slab) % (1 << 63)


def _sgns_slab(syn0, syn1, corpus, row_perm, n_rows, slab, slab_rows, gen, keep_prob,
               alias, thresh, lr, *, window, negative) -> None:
    """One device SGNS step: slice the slab's rows of the epoch's
    permutation, draw its keeps, windows and negatives, apply the masked
    skip-gram update."""
    rows = row_perm[slab * slab_rows: (slab + 1) * slab_rows]
    row_valid = slab * slab_rows + torch.arange(slab_rows, device=rows.device) < n_rows
    toks = corpus.index_select(0, rows)
    keep, red = _slab_draws(toks, keep_prob, window, gen)
    centers, contexts, mask = _device_pair_slab(toks, row_valid, keep, red, window)
    cell, u = _negative_draws(centers.shape[0], negative, alias.shape[0], gen, rows.device)
    _sgd_core(syn0, syn1, centers, contexts, _alias_negatives(cell, u, alias, thresh), lr, mask)


def _train_device(syn0, syn1, corpus_ranked, keep_prob, neg_probs, rng,
                  *, window, negative, iterations, alpha, min_alpha,
                  batch_pairs, seed, slabs_per_dispatch):
    """The host side of the device-resident pipeline.  Per iteration the
    host draws one row permutation and queues its slabs; pair and
    negative generation and the updates run on the tables' device.
    ``slabs_per_dispatch`` is the JAX package's scan length; here every
    slab is queued as it comes, so it changes nothing."""
    del slabs_per_dispatch
    device = syn0.device
    R, L = corpus_ranked.shape
    slots = _pair_slots_per_row(L, window)
    if batch_pairs is None:
        batch_pairs = 1 << 17          # potential slots/step (~55k real)
    slab_rows = int(np.clip(batch_pairs // max(slots, 1), 1, R))
    slabs_per_epoch = -(-R // slab_rows)
    total_slabs = slabs_per_epoch * iterations

    corpus = host_to_device(corpus_ranked.astype(np.int32), device)
    V = syn0.shape[0]
    keep = host_to_device(keep_prob if keep_prob is not None else np.ones(V, np.float32),
                          device)
    alias, thresh = (host_to_device(a, device) for a in _build_alias(neg_probs))
    gen = torch.Generator(device=device)
    for it in range(iterations):
        perm = rng.permutation(R)
        pad = slabs_per_epoch * slab_rows - R
        perm = host_to_device(np.concatenate([perm, np.zeros(pad, np.int64)]).astype(np.int32),
                              device)
        for s in range(slabs_per_epoch):
            frac = np.float32(it * slabs_per_epoch + s) / np.float32(total_slabs)
            lr = float(np.float32(alpha - (alpha - min_alpha) * frac))
            gen.manual_seed(_slab_seed(seed, it, s))
            _sgns_slab(syn0, syn1, corpus, perm, R, s, slab_rows, gen, keep, alias, thresh,
                       lr, window=window, negative=negative)


def train_word2vec(
    corpus: np.ndarray,            # (R, L) int32 token ids in [0, n_tokens)
    n_tokens: int,
    *,
    dim: int = 768,
    window: int = 3,
    negative: int = 5,
    iterations: int = 1,
    alpha: float = 0.025,
    min_alpha: float = 1e-4,
    sample: float = 1e-3,
    sg: bool = True,
    seed: int = 1,
    batch_pairs: Optional[int] = None,
    index_to_name: Optional[list] = None,
    device_pipeline: bool = False,
    slabs_per_dispatch: int = 32,
    device="cuda",
) -> Word2VecResult:
    """Train embeddings over a walk corpus on ``device`` (fp32 tables);
    rows count-sorted like gensim.

    ``device_pipeline=True`` keeps the whole SGNS stage on the device (see
    the module docstring): the same vocabulary, subsampling, negative
    distribution, window rule and masked-mean update as the host
    pipeline; only the random streams and the shuffle granularity (row
    order, gensim's own, instead of pair order) differ, and
    ``batch_pairs`` then budgets POTENTIAL pair slots a step (~55-60%
    carry mask=1 under window-3 dynamic windows).  The device pipeline
    trains skip-gram only."""
    device = _check_device(device)
    rng = np.random.default_rng(seed)
    counts, order, rank = _build_vocab(corpus, n_tokens)
    corpus_ranked = rank[corpus].astype(np.int32)      # ids = count ranks
    counts_sorted = counts[order]
    keep_prob = _keep_probabilities(counts_sorted, sample)
    neg_probs = _negative_probabilities(counts_sorted)

    syn0 = _init_syn0(n_tokens, dim, seed, device)
    syn1 = torch.zeros((n_tokens, dim), dtype=F32, device=device)
    kw = dict(window=window, negative=negative, iterations=iterations, alpha=alpha,
              min_alpha=min_alpha, batch_pairs=batch_pairs)
    with torch.no_grad():
        if device_pipeline:
            _train_device(syn0, syn1, corpus_ranked, keep_prob, neg_probs, rng, seed=seed,
                          slabs_per_dispatch=slabs_per_dispatch, **kw)
        else:
            _train_host(syn0, syn1, corpus_ranked, keep_prob, neg_probs, rng, sg=sg, **kw)
    names = ([index_to_name[i] for i in order] if index_to_name is not None
             else [int(i) for i in order])
    return Word2VecResult(vectors=syn0.cpu().numpy(), index_to_word=names,
                          counts=counts_sorted)
