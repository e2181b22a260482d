# gpmp_tpu_torch/ops/__init__.py
"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- ``gram``: K1 (Matern gram forward) and K2 (its parameter pullback).
- ``_build``: builds ``gpmp_tpu_torch/csrc/*.cu`` with nvcc at first use.
"""

from . import gram

__all__ = ["gram"]
