"""Fast host-side parameter initialisation.

The port of the JAX package's ``stonkgs_tpu/utils/init.py``.  The ``init_*``
functions draw truncated normals leaf by leaf, which is slow for 300 M
parameters; for benchmarks and compile checks :func:`fast_init` takes the
tree's shapes from an ``init_*`` run on the ``meta`` device (no storage,
no draws) and fills them with numpy on the host: floats from N(0, std^2),
integers zero.  The tree is then placed on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from stonkgs_tpu_torch.utils.convert import params_to
from stonkgs_tpu_torch.utils.tree import tree_map


def fast_random_like(shape_tree, seed: int = 0, std: float = 0.02, device="cuda"):
    """A tree of the same structure, shapes and dtypes as ``shape_tree``
    (tensors, e.g. on ``meta``), filled from ``numpy.random.default_rng(
    seed)`` in leaf order and placed on ``device``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fast_init: no CUDA device; pass device='cpu' to fill the "
                           "tree on the CPU")
    rng = np.random.default_rng(seed)

    def fill(t: torch.Tensor) -> torch.Tensor:
        if t.dtype.is_floating_point:
            values = torch.from_numpy(rng.standard_normal(tuple(t.shape), dtype=np.float32) * std)
            return values.to(t.dtype)
        return torch.zeros(tuple(t.shape), dtype=t.dtype)

    return params_to(tree_map(fill, shape_tree), device)


def fast_init(init_fn, *args, seed: int = 0, std: float = 0.02, device="cuda", **kwargs):
    """``init_fn(*args, **kwargs)``'s tree, its shapes taken on the ``meta``
    device and its values from :func:`fast_random_like` on ``device``."""
    with torch.device("meta"):
        shapes = init_fn(*args, **kwargs)
    return fast_random_like(shapes, seed=seed, std=std, device=device)
