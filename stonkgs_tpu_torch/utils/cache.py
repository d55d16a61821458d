"""A pystow-style cache of the published artifacts.

The port of the JAX package's ``stonkgs_tpu/utils/cache.py``: the
reference fetches every Zenodo and HF artifact with
``pystow.module("stonkgs").ensure(url=...)``; this is the same contract
without the dependency.  A file lands under
``$STONKGS_TPU_CACHE/<submodule>/<file name>`` (by default
``$STONKGS_TPU_HOME/cache``), the JAX package's layout, and is fetched
with ``urllib`` only when it is missing, so a filled cache works with no
network at all.
"""

from __future__ import annotations

import logging
import os
import urllib.request
from pathlib import Path

from stonkgs_tpu_torch.constants import HOME

logger = logging.getLogger(__name__)

CACHE_DIR = Path(os.getenv("STONKGS_TPU_CACHE", HOME / "cache"))


def cache_path(url: str, submodule: str = "") -> Path:
    """Where ``url`` lives in the cache: ``<cache>/<submodule>/<file name>``."""
    name = url.rsplit("/", 1)[-1]
    return CACHE_DIR / submodule / name if submodule else CACHE_DIR / name


def ensure(url: str, submodule: str = "", force: bool = False) -> Path:
    """The local path of ``url``, downloading it first only if it is not
    in the cache (or ``force``).  Without a network the error names the
    path to fill by hand."""
    path = cache_path(url, submodule)
    if path.exists() and not force:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    logger.info("downloading %s -> %s", url, path)
    tmp = path.with_suffix(path.suffix + ".part")
    try:
        urllib.request.urlretrieve(url, tmp)  # noqa: S310
    except Exception as e:  # no network, or a bad URL
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(
            f"could not download {url}; place the file manually at {path} "
            f"(offline environments)") from e
    tmp.rename(path)
    return path
