# gpmp_tpu_torch/ops/__init__.py
"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- ``distance``: K1d (the scaled distance and its pullback).
- ``gram``: K1 (Matern gram forward), K2 (its parameter pullback) and K1m
  (the Matern polynomial, elementwise, and its backward).
- ``mixed``: the mixed-precision Cholesky engine and its kernels K3
  (residual), K4 (factorization residual), K5 (diagonal-block triangular
  inverse), K7 (trace-series sums) and K7b (the LOO diagonal series).
- ``refine``: the sampling square root and its kernel K8s (f64 residual).
- ``_build``: builds ``gpmp_tpu_torch/csrc/*.cu`` with nvcc at first use.
"""

from . import distance, gram, mixed, refine

__all__ = ["distance", "gram", "mixed", "refine"]
