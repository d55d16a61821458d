"""Memory-mapped feature store for corpus-scale pre-training.

The port's copy of the JAX package's ``data/memmap_dataset.py``: the same
files (one ``.npy`` a feature, int32, and ``meta.json``), so a store
written by either package is read by the other, and the same batches from
the same seed.  The INDRA corpus is ~35M text-triple pairs, whose 512-token
features run to hundreds of GB: each feature is written once as an
``.npy`` memmap and shuffled batches are gathered through the OS page
cache.  Pure numpy.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator

import numpy as np

META_NAME = "meta.json"


class MemmapFeatureStore:
    """Directory of per-feature ``.npy`` memmaps with one shared length."""

    def __init__(self, directory: str, mode: str = "r"):
        self.directory = directory
        self.mode = mode
        self._arrays: Dict[str, np.memmap] = {}
        meta_path = os.path.join(directory, META_NAME)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.meta = json.load(f)
            for key in self.meta["features"]:
                self._arrays[key] = np.lib.format.open_memmap(
                    os.path.join(directory, f"{key}.npy"), mode=mode)
        else:
            self.meta = {"n_rows": 0, "features": {}}

    def __len__(self) -> int:
        return self.meta["n_rows"]

    def keys(self):
        return self._arrays.keys()

    def __getitem__(self, key):
        return self._arrays[key]

    @classmethod
    def write(cls, directory: str, features: Dict[str, np.ndarray],
              dtype=np.int32) -> "MemmapFeatureStore":
        """Create a store from in-memory arrays (one-time conversion)."""
        os.makedirs(directory, exist_ok=True)
        n = len(next(iter(features.values())))
        meta = {"n_rows": int(n), "features": {}}
        for key, arr in features.items():
            arr = np.asarray(arr)
            out = np.lib.format.open_memmap(
                os.path.join(directory, f"{key}.npy"), mode="w+",
                dtype=dtype, shape=arr.shape)
            out[:] = arr
            out.flush()
            meta["features"][key] = {"shape": list(arr.shape),
                                     "dtype": np.dtype(dtype).name}
        with open(os.path.join(directory, META_NAME), "w") as f:
            json.dump(meta, f)
        return cls(directory)

    @classmethod
    def convert_chunked(cls, directory: str, chunks, dtype=np.int32
                        ) -> "MemmapFeatureStore":
        """Build a store from an iterator of feature-dict chunks without
        holding the corpus in memory: each feature is appended to a raw
        file, which is then copied into its ``.npy`` in 128 MiB slices."""
        os.makedirs(directory, exist_ok=True)
        writers: Dict[str, object] = {}
        n = 0
        shapes = {}
        tmp_paths = {}
        for chunk in chunks:
            m = len(next(iter(chunk.values())))
            for key, arr in chunk.items():
                arr = np.asarray(arr, dtype)
                if key not in writers:
                    tmp_paths[key] = os.path.join(directory, f"{key}.bin")
                    writers[key] = open(tmp_paths[key], "wb")
                    shapes[key] = arr.shape[1:]
                writers[key].write(np.ascontiguousarray(arr).tobytes())
            n += m
        meta = {"n_rows": int(n), "features": {}}
        for key, fh in writers.items():
            fh.close()
            shape = (n,) + tuple(shapes[key])
            out = np.lib.format.open_memmap(
                os.path.join(directory, f"{key}.npy"), mode="w+",
                dtype=dtype, shape=shape)
            raw = np.memmap(tmp_paths[key], dtype=dtype, mode="r", shape=shape)
            step = max(1, (1 << 27) // max(int(np.prod(shape[1:])) * 4, 1))
            for i in range(0, n, step):
                out[i: i + step] = raw[i: i + step]
            out.flush()
            del raw
            os.remove(tmp_paths[key])
            meta["features"][key] = {"shape": list(shape),
                                     "dtype": np.dtype(dtype).name}
        with open(os.path.join(directory, META_NAME), "w") as f:
            json.dump(meta, f)
        return cls(directory)


def memmap_data_iterator(
    store: MemmapFeatureStore,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle_buffer: int = 1 << 16,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffling epoch iterator over a memmap store: a full random
    permutation of the row indices an epoch, each batch's indices sorted
    so that its gathers read the files in order.  ``shuffle_buffer`` is
    accepted for the JAX package's signature and unused there too."""
    n = len(store)
    if n < batch_size:
        raise ValueError(
            f"store has {n} rows < batch_size {batch_size}: the epoch "
            f"loop would never yield")
    rng = np.random.default_rng(seed)
    keys = list(store.keys())
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = np.sort(perm[i: i + batch_size])
            yield {k: np.asarray(store[k][idx]) for k in keys}
