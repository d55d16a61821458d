"""stonkgs_tpu_torch: the PyTorch/CUDA port of stonkgs_tpu for NVIDIA Hopper.

A package of its own beside the JAX package: it imports torch and never
jax or stonkgs_tpu.  Its kernels are CUDA C++ under ``csrc/``, built with
nvcc for ``sm_90a`` the first time they launch.
"""

from stonkgs_tpu_torch.api.inference import STonKGsEngine
from stonkgs_tpu_torch.api.prot_inference import ProtSTonKGsEngine

__all__ = ["ProtSTonKGsEngine", "STonKGsEngine"]
