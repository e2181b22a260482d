# gpmp_tpu_torch/ops/__init__.py
"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- ``gram``: K1 (Matern gram forward) and K2 (its parameter pullback).
- ``mixed``: the mixed-precision Cholesky engine and its kernels K3
  (residual), K4 (factorization residual), K5 (diagonal-block triangular
  inverse) and K7 (trace-series sums).
- ``_build``: builds ``gpmp_tpu_torch/csrc/*.cu`` with nvcc at first use.
"""

from . import gram, mixed

__all__ = ["gram", "mixed"]
