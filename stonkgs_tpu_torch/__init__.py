"""stonkgs_tpu_torch: the PyTorch/CUDA port of stonkgs_tpu for NVIDIA Hopper.

A package of its own beside the JAX package: it imports torch and never
jax or stonkgs_tpu.  Its kernels are CUDA C++ under ``csrc/``, built with
nvcc for ``sm_90a`` the first time they launch.

The public surface is the JAX package root's (``stonkgs_tpu/__init__.py``,
the reference package's): the configs and the version at import, and the
engines, the embedding API, ``prepare_df``, ``replace_mlm_tokens`` and the
``infer_*`` / ``ensure_*`` functions on first use, so that ``import
stonkgs_tpu_torch`` stays light.
"""

from stonkgs_tpu_torch.config import (  # noqa: F401
    BertConfig,
    BigBirdConfig,
    ProtSTonKGsConfig,
    STonKGsConfig,
)
from stonkgs_tpu_torch.version import VERSION, get_version  # noqa: F401

__version__ = VERSION

__all__ = [
    "BertConfig",
    "BigBirdConfig",
    "ProtSTonKGsConfig",
    "STonKGsConfig",
    "STonKGsEngine",
    "ProtSTonKGsEngine",
    "get_stonkgs_embeddings",
    "preprocess_df_for_embeddings",
    "get_version",
]


def __getattr__(name):
    if name == "STonKGsEngine":
        from stonkgs_tpu_torch.api.inference import STonKGsEngine
        return STonKGsEngine
    if name == "ProtSTonKGsEngine":
        from stonkgs_tpu_torch.api.prot_inference import ProtSTonKGsEngine
        return ProtSTonKGsEngine
    if name in ("get_stonkgs_embeddings", "preprocess_df_for_embeddings"):
        from stonkgs_tpu_torch.api import embeddings
        return getattr(embeddings, name)
    if name == "prepare_df":
        from stonkgs_tpu_torch.data.artifacts import prepare_df
        return prepare_df
    if name == "replace_mlm_tokens":
        from stonkgs_tpu_torch.data.masking import replace_mlm_tokens
        return replace_mlm_tokens
    if name.startswith("infer_") or name.startswith("ensure_"):
        from stonkgs_tpu_torch.api import api
        if hasattr(api, name):
            return getattr(api, name)
    raise AttributeError(f"module 'stonkgs_tpu_torch' has no attribute {name!r}")
