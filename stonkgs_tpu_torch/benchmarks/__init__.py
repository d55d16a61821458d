"""Benchmarks of the port, run on one CUDA card as modules, e.g.
``python -m stonkgs_tpu_torch.benchmarks.bench_int8_gemm``."""
