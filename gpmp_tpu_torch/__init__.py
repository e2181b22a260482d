# gpmp_tpu_torch/__init__.py
"""gpmp_tpu_torch: the PyTorch / CUDA port of gpmp_tpu.

Same public layout as gpmp_tpu: ``Model`` at the root plus lazily-loaded
submodules.  The Matern gram matrix and its parameter gradient, and the
scaled distance and Matern polynomial that user covariances compose, run
as hand-written CUDA kernels on the card (``ops.gram``, ``ops.distance``);
the factorizations go to ``torch.linalg``, or, with
``config.set_chol_engine("mixed")``, to the mixed-precision engine and its
kernels (``ops.mixed``, and ``ops.refine`` for the sampling root); past the
resident engines' memory, ``parallel`` runs REML on one card through the
streamed engine and its kernels (``ops.streamed``), and on the ranks of a
torch.distributed group through the row-sharded blocked Cholesky
(``ops.chol``).  Everything
runs on the card unless the CPU is asked for (``config.set_device("cpu")``
or ``GPMP_DEVICE=cpu``).
"""

from __future__ import annotations

import importlib
from typing import Final

from . import config as config  # eager: sets up dtype/device before num import
from .core import Model

__all__ = [
    "Model",
    "__version__",
    "config",
    "num",
    "kernel",
    "core",
    "dataloader",
    "modeldiagnosis",
    "parameter",
    "misc",
    "plot",
    "ops",
    "interop",
    "parallel",
]

__version__ = "0.1.0"

_LAZY_SUBMODULES: Final[set] = {
    "num", "kernel", "dataloader", "modeldiagnosis", "parameter", "misc", "plot", "ops",
    "interop", "parallel",
}


def __getattr__(name: str):
    if name in _LAZY_SUBMODULES:
        module = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals().keys()) | _LAZY_SUBMODULES)
