# gpmp_tpu_torch/kernel/exponential.py
"""Exponential kernel (counterpart of gpmp_tpu/kernel/exponential.py)."""

import torch


def exponential_kernel(h):
    """k(h) = exp(-h)."""
    return torch.exp(-h)
