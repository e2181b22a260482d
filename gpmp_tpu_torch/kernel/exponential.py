# gpmp_tpu_torch/kernel/exponential.py
"""Exponential kernel (counterpart of gpmp_tpu/kernel/exponential.py)."""

import torch

import gpmp_tpu_torch.num as gnp


def exponential_kernel(h):
    """k(h) = exp(-h)."""
    return torch.exp(-gnp._tensor(h))
