# gpmp_tpu_torch/config.py
"""Process-wide configuration for gpmp_tpu_torch (the PyTorch port).

Counterpart of gpmp_tpu/config.py.  Differences, by design:

- device: the card ("cuda") by default.  A computation that was not told
  to use the CPU (``set_device("cpu")`` or ``GPMP_DEVICE=cpu``) runs on the
  card; on a host without one, the first tensor the port creates raises.
  There is no fallback to the CPU.  Importing the package needs no card.
- Cholesky engine: "auto" (= "f64", exact double-precision
  factorizations) or "mixed" (f32 factorization + f64 refinement,
  gpmp_tpu_torch.ops.mixed), as in the JAX package.

Environment variables read at import:
  GPMP_DTYPE        "float64" (default) or "float32"
  GPMP_DEVICE       "cuda" (default), "cuda:<k>" or "cpu"; an explicit
                    "cuda" on a host without a card raises at import
  GPMP_LOG_LEVEL    standard logging level name
  GPMP_CHOL_ENGINE  "auto" (default) / "f64" / "mixed"

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
_VALID_CHOL_ENGINES = ("auto", "f64", "mixed")

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


def _check_card(dev: torch.device) -> None:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; ask for the CPU with set_device('cpu') or GPMP_DEVICE=cpu"
        )


def _validate_device(spec: Any) -> str:
    dev = torch.device(spec)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"Unsupported device {str(dev)!r}; expected cpu or cuda.")
    _check_card(dev)
    return str(dev)


@dataclass
class _GPmpTorchConfig:
    dtype: str = "float64"
    dtype_resolved: Any = None  # set by gpmp_tpu_torch.num at import
    device: str = "cuda"  # checked when the first tensor is made, not at import
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
    """The device on which gnp creates tensors; raises if it is the card and
    there is none."""
    dev = torch.device(_config.device)
    _check_card(dev)
    return dev


def _check_chol_engine(name: str) -> str:
    if name not in _VALID_CHOL_ENGINES:
        raise ValueError(
            f"Unknown Cholesky engine {name!r}; expected one of {_VALID_CHOL_ENGINES}."
        )
    return name


def set_chol_engine(name: str) -> None:
    """Select the Cholesky engine for hot-path SPD solves.

    'auto' (= 'f64'): exact double-precision factorizations.
    'mixed': f32 factorization + f64 refinement (gpmp_tpu_torch.ops.mixed),
    engaged for n >= 192 (core.linalg.chol_engine).
    """
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
