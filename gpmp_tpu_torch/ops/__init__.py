# gpmp_tpu_torch/ops/__init__.py
"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- ``distance``: K1d (the scaled distance and its pullback).
- ``gram``: K1 (Matern gram forward), K2 (its parameter pullback) and K1m
  (the Matern polynomial, elementwise, and its backward).
- ``mixed``: the mixed-precision Cholesky engine and its kernels K3
  (residual), K4 (factorization residual), K5 (diagonal-block triangular
  inverse), K6 (preconditioner apply), K7 (trace-series sums) and K7b (the
  LOO diagonal series).
- ``refine``: the sampling square root and its kernel K8s (f64 residual).
- ``streamed``: the kernels of the streamed large-n engine
  (gpmp_tpu_torch.parallel.streamed): K10b (row-chunk split into the f32
  pair), K10r (factorization residual from the pair or from f64 panels),
  K10m (residual against the pair) and K10t (chunked trace sums).
- ``capture``: a launch sequence captured once as a CUDA graph and
  replayed (its launches counted, the cached launch state it points into
  held).
- ``_build``: builds ``gpmp_tpu_torch/csrc/*.cu`` with nvcc at first use.
"""

from . import chol, distance, gram, mixed, refine, streamed

__all__ = ["chol", "distance", "gram", "mixed", "refine", "streamed"]
