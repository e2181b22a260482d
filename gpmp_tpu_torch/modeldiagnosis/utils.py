# gpmp_tpu_torch/modeldiagnosis/utils.py
"""Diagnosis utilities (reference gpmp/modeldiagnosis/utils.py:34-169)."""

from typing import Any, Dict

import numpy as np

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.misc.dataframe import DataFrame, ftos


def sigma_rho_from_covparam(covparam) -> Dict[str, Any]:
    """{sigma, rho0, rho1, ...} from covparam = [log sigma2, loginvrho...]."""
    covparam = np.asarray(gnp.to_np(gnp.asarray(covparam))).reshape(-1)
    out: Dict[str, Any] = {"sigma": np.exp(0.5 * covparam[0])}
    for i in range(covparam.shape[0] - 1):
        out[f"rho{i:d}"] = np.exp(-covparam[i + 1])
    return out


def describe_array(x, rownames, sigma_factor=None):
    """Per-dimension min/max/delta/mean/std (+ delta_over_sigma) DataFrame."""
    x = np.asarray(gnp.to_np(gnp.asarray(x)))
    dim = 1 if x.ndim == 1 else x.shape[1]

    if sigma_factor is None:
        colnames = ["min", "max", "delta", "mean", "std"]
        data = np.empty((dim, 5), dtype=float)
    else:
        colnames = ["min", "max", "delta", "mean", "std", "delta_over_sigma"]
        data = np.empty((dim, 6), dtype=float)

    data[:, 0] = np.atleast_1d(np.min(x, axis=0)).astype(float)
    data[:, 1] = np.atleast_1d(np.max(x, axis=0)).astype(float)
    data[:, 2] = data[:, 1] - data[:, 0]
    data[:, 3] = np.atleast_1d(np.mean(x, axis=0)).astype(float)
    data[:, 4] = np.atleast_1d(np.std(x, axis=0)).astype(float)

    if sigma_factor is not None:
        sf = np.asarray(gnp.to_np(gnp.asarray(sigma_factor)), dtype=float)
        if sf.ndim == 0:
            sf = np.full((dim,), float(sf))
        else:
            sf = sf.reshape(-1)
            if sf.size != dim:
                raise ValueError(
                    "sigma_factor must be a scalar or have length equal to "
                    "the number of columns in x."
                )
        data[:, 5] = data[:, 2] * sf

    return DataFrame(data, colnames, rownames)


def pretty_print_dictionary(d: Dict[str, Any], fp: int = 4) -> None:
    """Print a dict with right-aligned keys and compact float formatting."""
    if not d:
        return
    max_key_length = max(15, max(len(str(k)) for k in d.keys()) + 2)
    for k, v in d.items():
        if not np.isscalar(v):
            try:
                v = v.item()
            except Exception:
                pass
        if isinstance(v, float):
            print(f"{str(k):>{max_key_length}s}: {ftos(v, fp)}")
        else:
            print(f"{str(k):>{max_key_length}s}: {v}")


def pretty_print_dictionnary(d: Dict[str, Any], fp: int = 4) -> None:
    """Backward-compatible alias (reference keeps the misspelling)."""
    pretty_print_dictionary(d, fp=fp)


__all__ = [
    "sigma_rho_from_covparam",
    "describe_array",
    "pretty_print_dictionary",
    "pretty_print_dictionnary",
]
