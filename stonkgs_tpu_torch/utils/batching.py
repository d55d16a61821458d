"""Fixed-size batched inference helper.

Chunk the features and pad the final batch by repeating its last row, so
every batch the device sees has the same shape.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def iter_padded_batches(
    features: Dict[str, np.ndarray],
    keys: Sequence[str],
    batch_size: int,
    device: torch.device | str = "cpu",
):
    """Yield (chunk dict of int64 tensors on ``device``, n_valid)."""
    keys = [k for k in keys if k in features]
    n = len(features[keys[0]])
    for i in range(0, n, batch_size):
        chunk = {k: np.asarray(features[k][i: i + batch_size]) for k in keys}
        valid = len(chunk[keys[0]])
        if valid < batch_size:
            chunk = {
                k: np.concatenate(
                    [v, np.repeat(v[-1:], batch_size - valid, axis=0)], axis=0)
                for k, v in chunk.items()
            }
        yield {k: torch.as_tensor(v, dtype=torch.int64).to(device)
               for k, v in chunk.items()}, valid
