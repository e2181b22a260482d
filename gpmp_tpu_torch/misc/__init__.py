# gpmp_tpu_torch/misc/__init__.py
"""Miscellaneous utilities: designs, test functions, scoring rules, tables."""

from . import dataframe, designs, scoringrules, testfunctions

__all__ = ["dataframe", "designs", "scoringrules", "testfunctions"]
