# gpmp_tpu_torch/config.py
"""Process-wide configuration for gpmp_tpu_torch (the PyTorch port).

Counterpart of gpmp_tpu/config.py.  Differences, by design:

- device: "cpu" by default (PyTorch's own default).  ``set_device("cuda")``
  or ``GPMP_DEVICE=cuda`` selects the card; asking for a CUDA device when
  none is available raises.  There is no silent CPU fallback.
- Cholesky engine: only the exact f64 engine is ported ("auto" = "f64");
  "mixed" raises NotImplementedError (ROADMAP queue 1 item 8).

Environment variables read at import:
  GPMP_DTYPE        "float64" (default) or "float32"
  GPMP_DEVICE       "cpu" (default), "cuda" or "cuda:<k>"
  GPMP_LOG_LEVEL    standard logging level name
  GPMP_CHOL_ENGINE  "auto" (default) / "f64"

At import, TF32 is switched off for float32 matmuls and cuDNN and the
float32 matmul precision is pinned to "highest": the analogue of the JAX
package pinning jax_default_matmul_precision=highest.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

_VALID_DTYPES = ("float64", "float32")
_VALID_CHOL_ENGINES = ("auto", "f64")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _normalize_dtype_spec(spec: Any) -> str:
    """Normalize a dtype spec ('float64', torch/np dtype, ...) to a string."""
    if spec is None:
        return "float64"
    s = str(spec)
    for cand in _VALID_DTYPES:
        if cand in s:
            return cand
    raise ValueError(
        f"Unsupported dtype spec {spec!r}; expected one of {_VALID_DTYPES}."
    )


def _validate_device(spec: Any) -> str:
    dev = torch.device(spec)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"Unsupported device {str(dev)!r}; expected cpu or cuda.")
    return str(dev)


@dataclass
class _GPmpTorchConfig:
    dtype: str = "float64"
    dtype_resolved: Any = None  # set by gpmp_tpu_torch.num at import
    device: str = "cpu"
    chol_engine: str = "auto"
    logger: Optional[logging.Logger] = None


_config = _GPmpTorchConfig()


def get_config() -> _GPmpTorchConfig:
    return _config


def set_dtype(spec: Any) -> None:
    """Set the working dtype.  Must be called before importing gpmp_tpu_torch.num."""
    dtype = _normalize_dtype_spec(spec)
    if _config.dtype_resolved is not None and dtype != _config.dtype:
        raise RuntimeError(
            "dtype cannot be changed after gpmp_tpu_torch.num has been imported."
        )
    _config.dtype = dtype


def set_device(device: Any) -> None:
    """Select the device on which gnp creates tensors ("cpu", "cuda", "cuda:k").

    Raises when a CUDA device is asked for and none is available.
    """
    _config.device = _validate_device(device)


def get_device() -> torch.device:
    return torch.device(_config.device)


def _check_chol_engine(name: str) -> str:
    if name == "mixed":
        raise NotImplementedError(
            "The 'mixed' Cholesky engine is not ported yet "
            "(ROADMAP queue 1 item 8); use 'auto' or 'f64'."
        )
    if name not in _VALID_CHOL_ENGINES:
        raise ValueError(
            f"Unknown Cholesky engine {name!r}; expected one of {_VALID_CHOL_ENGINES}."
        )
    return name


def set_chol_engine(name: str) -> None:
    """Select the Cholesky engine for hot-path SPD solves ('auto' = 'f64')."""
    _config.chol_engine = _check_chol_engine(name)


def get_chol_engine() -> str:
    return _config.chol_engine


def get_logger() -> logging.Logger:
    if _config.logger is None:
        logger = logging.getLogger("gpmp_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
            logger.addHandler(handler)
        level = os.environ.get("GPMP_LOG_LEVEL", "WARNING").upper()
        logger.setLevel(getattr(logging, level, logging.WARNING))
        _config.logger = logger
    return _config.logger


def set_log_level(level: str) -> None:
    get_logger().setLevel(getattr(logging, level.upper()))


_env_dtype = os.environ.get("GPMP_DTYPE")
if _env_dtype is not None:
    _config.dtype = _normalize_dtype_spec(_env_dtype)
_env_device = os.environ.get("GPMP_DEVICE")
if _env_device is not None:
    _config.device = _validate_device(_env_device)
_config.chol_engine = _check_chol_engine(os.environ.get("GPMP_CHOL_ENGINE", "auto"))
