# gpmp_tpu_torch/core/__init__.py
"""Core GP math: Model facade + pure numerical routines (counterpart of
gpmp_tpu/core)."""

from .model import Model
from . import fisher, kriging, likelihood, linalg, loo, sample_paths, utils

__all__ = ["Model", "fisher", "kriging", "likelihood", "linalg", "loo", "sample_paths",
           "utils"]
