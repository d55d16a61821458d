"""CSR graph construction and native random-walk sampling.

The port's copy of the JAX package's ``data/walker.py``: the Python front
of the port's own ``csrc/walker.cpp``, built with g++ at first use into
``csrc/build/`` (as the tokenizer is, :mod:`~stonkgs_tpu_torch.data.fast_tokenizer`),
with the numpy fallback for a machine without a compiler (p = q = 1
only).  It replaces csrgraph/nodevectors in the reference's node2vec
pipeline.  The native walks depend on (seed, walk row) only, so they are
the same on any number of threads, and equal the JAX package's bit for
bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading
import warnings
from typing import List, Optional, Sequence

import numpy as np

from stonkgs_tpu_torch.data.fast_tokenizer import BUILD_DIR, CSRC, _build_to, _stale

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


@dataclasses.dataclass
class CSRGraph:
    """Undirected (symmetrized) CSR graph over named nodes."""

    names: List[str]
    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (E,) int32, sorted within each row

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    @classmethod
    def from_edges(cls, sources: Sequence[str], targets: Sequence[str],
                   directed: bool = False) -> "CSRGraph":
        """Build from name pairs; node ids by first appearance, source
        before target (csrgraph's ``read_edgelist`` keeps insertion order)."""
        ids: dict = {}
        pairs = np.fromiter((ids.setdefault(n, len(ids))
                             for pair in zip(sources, targets) for n in pair),
                            np.int32).reshape(-1, 2)
        src_ids, tgt_ids = pairs[:, 0], pairs[:, 1]
        n = len(ids)
        if directed:
            rows, cols = src_ids, tgt_ids
        else:
            rows = np.concatenate([src_ids, tgt_ids])
            cols = np.concatenate([tgt_ids, src_ids])
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(list(ids), indptr, cols.astype(np.int32))


def _load_lib() -> Optional[ctypes.CDLL]:
    """Build (if stale) and load ``libwalker.so``; None if that fails."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        src, so = CSRC / "walker.cpp", BUILD_DIR / "libwalker.so"
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            if _stale(so, src):
                _build_to(so, ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                               "-o", "{out}", str(src)])
            lib = ctypes.CDLL(str(so))
        except subprocess.CalledProcessError as e:
            warnings.warn(f"native walker did not build, using numpy: {e.stderr[-2000:]}")
            _lib_failed = True
            return None
        except OSError as e:   # no g++, or the library does not load
            warnings.warn(f"native walker unavailable, using numpy: {e}")
            _lib_failed = True
            return None
        lib.random_walks.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.random_walks.restype = None
        _lib = lib
        return lib


def is_native() -> bool:
    """Whether walks come from the C++ walker (built and loaded)."""
    return _load_lib() is not None


def random_walks(
    graph: CSRGraph,
    walk_len: int = 127,
    epochs: int = 4,
    seed: int = 0,
    p: float = 1.0,
    q: float = 1.0,
    n_threads: Optional[int] = None,
) -> np.ndarray:
    """(epochs * n_nodes, walk_len) int32 walk matrix, epoch-major.

    Epoch e row i starts at node i (nodevectors semantics: one walk per
    node per epoch)."""
    n = graph.n_nodes
    out = np.empty((epochs * n, walk_len), np.int32)
    lib = _load_lib()
    if lib is None:
        return _numpy_walks(graph, walk_len, epochs, seed, p, q, out)
    indptr = np.ascontiguousarray(graph.indptr, np.int64)
    indices = np.ascontiguousarray(graph.indices, np.int32)
    if indptr.shape != (n + 1,) or indptr[-1] != len(indices):
        raise ValueError(f"CSR arrays disagree: indptr {indptr.shape}, {len(indices)} indices "
                         f"for {n} nodes")
    lib.random_walks(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, walk_len, epochs, seed, p, q, n_threads or os.cpu_count() or 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _numpy_walks(graph, walk_len, epochs, seed, p, q, out) -> np.ndarray:
    """Pure-numpy fallback (first order only)."""
    if p != 1.0 or q != 1.0:
        raise ValueError("the numpy walker supports p = q = 1 only")
    rng = np.random.default_rng(seed)
    n = graph.n_nodes
    deg = np.diff(graph.indptr)
    for e in range(epochs):
        cur = np.arange(n, dtype=np.int64)
        out[e * n:(e + 1) * n, 0] = cur
        for t in range(1, walk_len):
            d = deg[cur]
            off = (rng.random(n) * np.maximum(d, 1)).astype(np.int64)
            nxt = graph.indices[graph.indptr[cur] + np.minimum(off, np.maximum(d - 1, 0))]
            nxt = np.where(d > 0, nxt, cur).astype(np.int64)
            out[e * n:(e + 1) * n, t] = nxt
            cur = nxt
    return out
