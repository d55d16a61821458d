"""The modules a run must not load: JAX, jaxlib, flax and the JAX package.
Top-level names are compared whole, since the port's name
(``stonkgs_tpu_torch``) begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "stonkgs_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in this process's ``sys.modules``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
