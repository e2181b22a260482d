# gpmp_tpu_torch/plot/__init__.py
"""Plotting helpers (counterpart of gpmp_tpu/plot); importing this package
imports matplotlib."""

from .plotutils import Figure, crosssections, plot_loo

__all__ = ["Figure", "crosssections", "plot_loo"]
