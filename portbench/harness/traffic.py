"""The one generator of the benchmark's inputs: feature rows from a
traffic file's ``segments`` and the run's seed.

A row is the concatenation of its segments.  A segment has ``len``
positions and draws its ids from ``tokens``: ``[lo, hi)``, or ``"kg"``
for rows of the KG table (entities, never the special rows).  With
``fill`` its true length is drawn (``lognormal`` with a median and sigma,
clipped to [min, max]); the rest is padding (id 0, mask 0), and
``first`` / ``last`` put fixed ids at the ends of the true length.  With
``labels`` and ``mask_share`` it is masked as pre-training data is:
``int(share · n)`` (at least one) of its n maskable positions take
``mask_id`` and keep their original id (for KG positions: the entity's
index) as the label under the ``labels`` key, every other position -100.

Every seed draws rows of the same shapes and the same work: the program
pads each row to its full length, so the lengths drawn change only which
positions are real.  Requests take ``rows_per_request`` rows of a seeded
permutation of the corpus, in turn.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IGNORE = -100


def _lengths(rng, fill: dict, n: int) -> np.ndarray:
    if fill["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {fill['dist']!r}")
    raw = rng.lognormal(np.log(fill["median"]), fill["sigma"], n)
    return np.clip(raw.astype(np.int64), fill["min"], fill["max"])


def entity_rows(kg_vocab: int, special_ids) -> np.ndarray:
    """Table row of each entity index: entity k at the k-th row that is no
    special id."""
    rows = np.setdiff1d(np.arange(kg_vocab + len(special_ids)), np.asarray(special_ids))
    return rows[:kg_vocab]


def features(traffic: dict, seed: int, n: int, kg_vocab: int, special_ids,
             token_types: bool) -> Dict[str, np.ndarray]:
    """``n`` rows of int64 features (input_ids, attention_mask, and
    token_type_ids where the model takes them; labels where segments
    carry them) drawn from ``seed``."""
    rng = np.random.default_rng([seed, 0x7261])
    rows_of = entity_rows(kg_vocab, special_ids)
    ids, mask, ttype = [], [], []
    labels: Dict[str, List[np.ndarray]] = {}
    for seg in traffic["segments"]:
        L = seg["len"]
        if seg["tokens"] == "kg":
            ent = rng.integers(0, kg_vocab, (n, L))
            x = rows_of[ent]
        else:
            lo, hi = seg["tokens"]
            ent = None
            x = rng.integers(lo, hi, (n, L))
        if "fill" in seg:
            true = _lengths(rng, seg["fill"], n)
        else:
            true = np.full(n, L)
        pos = np.arange(L)[None, :]
        real = pos < true[:, None]
        if "first" in seg:
            x[:, 0] = seg["first"]
        if "last" in seg:
            x[np.arange(n), true - 1] = seg["last"]
        x = np.where(real, x, 0)
        if "labels" in seg:
            lab = np.full((n, L), IGNORE, np.int64)
            share = seg.get("mask_share", 0.0)
            if share:
                lo_pos = 1 if "first" in seg else 0
                hi_pos = true - (1 if "last" in seg else 0)
                k = np.maximum((share * (hi_pos - lo_pos)).astype(np.int64), 1)
                maskable = (pos >= lo_pos) & (pos < hi_pos[:, None])
                order = np.argsort(np.where(maskable, rng.random((n, L)), 2.0), axis=1)
                at = np.zeros((n, L), bool)
                np.put_along_axis(at, order, pos < k[:, None], axis=1)
                lab = np.where(at, ent if ent is not None else x, IGNORE)
                x = np.where(at, seg["mask_id"], x)
            labels.setdefault(seg["labels"], []).append(lab)
        ids.append(x)
        mask.append(real)
        ttype.append(np.full((n, L), seg.get("token_type", 0)))
    out = {"input_ids": np.concatenate(ids, 1).astype(np.int64),
           "attention_mask": np.concatenate(mask, 1).astype(np.int64)}
    if token_types:
        out["token_type_ids"] = np.concatenate(ttype, 1).astype(np.int64)
    for k, parts in labels.items():
        out[k] = np.concatenate(parts, 1)
    if "next_sentence_labels" in traffic:
        out["next_sentence_labels"] = rng.integers(
            0, traffic["next_sentence_labels"], n).astype(np.int64)
    return out


def request_rows(traffic: dict, seed: int, n_corpus: int):
    """Endless row-index arrays of the requests, ``rows_per_request``
    each, through seeded permutations of the corpus."""
    rng = np.random.default_rng([seed, 0x7271])
    per = traffic["rows_per_request"]
    while True:
        perm = rng.permutation(n_corpus)
        for i in range(0, n_corpus - per + 1, per):
            yield perm[i: i + per]
