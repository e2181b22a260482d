# gpmp_tpu_torch/core/__init__.py
"""Core GP math: Model facade + pure numerical routines (counterpart of
gpmp_tpu/core; fisher is not ported yet)."""

from .model import Model
from . import kriging, likelihood, linalg, loo, sample_paths, utils

__all__ = ["Model", "kriging", "likelihood", "linalg", "loo", "sample_paths", "utils"]
