# gpmp_tpu_torch/misc/__init__.py
"""Miscellaneous utilities: designs and test functions (host-side NumPy)."""

from . import designs, testfunctions

__all__ = ["designs", "testfunctions"]
