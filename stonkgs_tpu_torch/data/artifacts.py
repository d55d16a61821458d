"""KG artifacts: node2vec embeddings and random walks, as dense arrays.

The port's copy of the JAX package's ``data/artifacts.py``.  Two TSV
files (no header; column 0 the node name, a BEL string such as
``p(HGNC:1748 ! CDH1)``) become:

  * ``name_to_idx``: entity name -> data index, in the embeddings file's
    order;
  * ``vectors``: (N, H) float32 embedding matrix in that order;
  * ``walk_indices``: (N, rw_len) int32 matrix of each node's random walk
    mapped to data indices,

so sequence assembly is a vectorized gather instead of a Python loop.

The files are read without pandas (a machine serving the port needs only
torch and numpy): fields split on tabs only, names kept verbatim.
pandas, which the JAX package reads them with, turns an index string such as ``NA``, ``null``
or ``nan`` into ``"nan"`` and an all-numeric name column into numbers
(``03`` -> ``3``); here every name stays as the file spells it.  BEL
names are never such strings, and on them both readers agree.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def read_tsv(path: PathLike, sep: str = "\t") -> Tuple[List[str], List[str]]:
    """Split a headerless TSV into (first field, rest of the line) per
    non-empty line, both as strings."""
    with open(path, encoding="utf-8", newline="") as f:
        text = f.read()
    names, rests = [], []
    for line in text.split("\n"):
        if line.endswith("\r"):
            line = line[:-1]
        if not line:
            continue
        name, _, rest = line.partition(sep)
        names.append(name)
        rests.append(rest)
    return names, rests


def parse_vectors(rests: List[str], sep: str = "\t") -> np.ndarray:
    """The numeric fields of :func:`read_tsv`'s rows as an (N, H) float32
    array, parsed to float64 first (as pandas does) and then cast."""
    if not rests:
        return np.zeros((0, 0), np.float32)
    return np.loadtxt(rests, delimiter=sep, dtype=np.float64, comments=None,
                      ndmin=2).astype(np.float32)


def prepare_df(embedding_path: PathLike, sep: str = "\t") -> Dict[str, np.ndarray]:
    """A headerless TSV -> ``{name: row}``, the reference's ``prepare_df``
    (``kg_baseline_model.py:270-280``), kept for its API: names verbatim
    (see the module's note), each row int64 where every field of the
    table is an integer, float64 where every field is a number, else its
    strings, as pandas types such a table.  The array loaders below are
    the ones the port uses."""
    names, rests = read_tsv(embedding_path, sep)
    fields = [r.split(sep) for r in rests]
    if all(re.fullmatch(r"[+-]?\d+", f) for row in fields for f in row):
        rows = [np.asarray(row, np.int64) for row in fields]
    else:
        try:
            rows = [np.asarray(row, np.float64) for row in fields]
        except ValueError:
            rows = [np.asarray(row, object) for row in fields]
    return dict(zip(names, rows))


@dataclasses.dataclass
class KGArtifacts:
    """Dense random-walk + embedding tables for the KG backbone."""

    names: List[str]
    name_to_idx: Dict[str, int]
    vectors: np.ndarray        # (N, H) float32
    walk_indices: np.ndarray   # (N, rw_len) int32, values are data indices
    rw_len: int

    @property
    def n_entities(self) -> int:
        return len(self.names)

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def walks_for(self, names: np.ndarray, unk_id: int = 100) -> np.ndarray:
        """(B,) array of entity names -> (B, rw_len) walk index rows.

        Unknown nodes get an all-``unk_id`` walk (the reference's UNK
        fallback)."""
        idx = np.fromiter(
            (self.name_to_idx.get(n, -1) for n in names), np.int64, len(names)
        )
        out = np.where(
            idx[:, None] >= 0,
            self.walk_indices[np.maximum(idx, 0)],
            np.int32(unk_id),
        )
        return out.astype(np.int32)


def load_kg_artifacts(
    embedding_path: PathLike,
    random_walk_path: PathLike,
    sep: str = "\t",
) -> KGArtifacts:
    """Load the embeddings and walks TSVs into dense arrays.

    Both must cover the same entities; the walks may list them in another
    order."""
    names, emb_rests = read_tsv(embedding_path, sep)
    walk_names, walk_rests = read_tsv(random_walk_path, sep)
    if len(names) != len(walk_names):
        raise ValueError("Embeddings and random walks must cover the same entities: "
                         f"{len(names)} against {len(walk_names)} rows")
    name_to_idx = {n: i for i, n in enumerate(names)}
    vectors = parse_vectors(emb_rests, sep)

    walks = [r.split(sep) for r in walk_rests]
    rw_len = len(walks[0]) if walks else 0
    if any(len(w) != rw_len for w in walks):
        raise ValueError(f"{random_walk_path}: walks of unequal length")
    try:
        flat = np.fromiter((name_to_idx[n] for w in walks for n in w), np.int32,
                           len(walks) * rw_len)
    except KeyError as e:
        raise ValueError(f"{random_walk_path}: walk visits {e.args[0]!r}, "
                         "which has no embedding") from None
    # reorder walk rows into the embeddings file's order
    walk_rows = {n: i for i, n in enumerate(walk_names)}
    order = np.fromiter((walk_rows[n] for n in names), np.int64, len(names))
    walk_indices = flat.reshape(len(walks), rw_len)[order]
    return KGArtifacts(names, name_to_idx, vectors, walk_indices, rw_len)


def save_kg_artifacts(
    artifacts: KGArtifacts, embedding_path: PathLike, random_walk_path: PathLike
) -> None:
    """Write artifacts in the node2vec TSV format that
    :func:`load_kg_artifacts` reads."""
    with open(embedding_path, "w", encoding="utf-8") as f:
        for name, vec in zip(artifacts.names, artifacts.vectors):
            f.write(name + "\t" + "\t".join(repr(float(v)) for v in vec) + "\n")
    with open(random_walk_path, "w", encoding="utf-8") as f:
        for name, walk in zip(artifacts.names, artifacts.walk_indices):
            f.write(
                name + "\t"
                + "\t".join(artifacts.names[int(w)] for w in walk) + "\n"
            )


def make_random_artifacts(
    n_entities: int, dim: int = 768, rw_len: int = 127, seed: int = 0,
    name_fmt: str = "node{}",
) -> KGArtifacts:
    """Synthetic artifacts for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    names = [name_fmt.format(i) for i in range(n_entities)]
    return KGArtifacts(
        names=names,
        name_to_idx={n: i for i, n in enumerate(names)},
        vectors=rng.normal(size=(n_entities, dim)).astype(np.float32),
        walk_indices=rng.integers(0, n_entities, (n_entities, rw_len), dtype=np.int32),
        rw_len=rw_len,
    )
