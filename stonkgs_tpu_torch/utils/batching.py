"""Fixed-size batched inference helpers.

Chunk the features and pad the final batch by repeating its last row, so
every batch the device sees has the same shape (the port's copy of the
JAX package's ``stonkgs_tpu/utils/batching.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch


def host_to_device(a: np.ndarray, device: torch.device | str,
                   dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (in ``dtype`` when given).
    To a card it goes from pinned host memory without blocking, so the
    host does not wait for the work already queued on the card."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:     # a read-only memmap's rows
        a = a.copy()
    t = torch.as_tensor(a, dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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
        yield {k: host_to_device(v, device, torch.int64) for k, v in chunk.items()}, valid


def batched_apply(
    fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    features: Dict[str, np.ndarray],
    keys: Sequence[str],
    batch_size: int,
    device: torch.device | str = "cpu",
) -> np.ndarray:
    """``fn(batch)[:n_valid]`` over every padded batch, concatenated as an
    fp32 numpy array.  Every batch is dispatched before the first is
    copied to the host.  An empty input runs one zero batch to learn the
    output's trailing shape and returns 0 rows of it ((0, num_labels)
    for logits)."""
    with torch.inference_mode():
        outs = [(fn(chunk), valid)
                for chunk, valid in iter_padded_batches(features, keys, batch_size, device)]
        if not outs:
            chunk = {k: torch.zeros((batch_size,) + np.shape(features[k])[1:],
                                    dtype=torch.int64, device=device)
                     for k in keys if k in features}
            outs = [(fn(chunk), 0)]
        return np.concatenate([out[:valid].float().cpu().numpy() for out, valid in outs],
                              axis=0)
