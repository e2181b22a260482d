# gpmp_tpu_torch/parameter/__init__.py
"""Structured parameter objects (counterpart of gpmp_tpu/parameter)."""

from .param import (
    Normalization,
    Param,
    make_anisotropic_param,
    param_from_covparam_anisotropic,
    param_from_covparam_anisotropic_noisy,
)

__all__ = [
    "Normalization",
    "Param",
    "make_anisotropic_param",
    "param_from_covparam_anisotropic",
    "param_from_covparam_anisotropic_noisy",
]
