# gpmp_tpu_torch/kernel/bounds.py
"""Empirical optimizer bounds for GP hyperparameters.

Counterpart of gpmp_tpu/kernel/bounds.py: host NumPy, once per fit.
"""

import numpy as np

import gpmp_tpu_torch.num as gnp


def _minimum_nonzero_gap_distance_1d(xj):
    """Smallest positive spacing among points in 1-D (inf if none)."""
    xj = np.asarray(xj).reshape(-1)
    if xj.shape[0] < 2:
        return np.inf
    diffs = np.diff(np.sort(xj))
    diffs = diffs[diffs > 0.0]
    return float(np.min(diffs)) if diffs.shape[0] > 0 else np.inf


def empirical_bounds_factory(
    xi,
    zi,
    *,
    mean_paramlength=0,
    var_lower_factor=2.0,
    var_upper_factor=10.0,
    length_lower_factor=2.0,
):
    """Bounds for params [mean..., log(sigma2), -log(rho_0), ...], as an
    (m, 2) tensor on the configured device."""
    xi = np.asarray(gnp.to_np(xi), dtype=float)
    zi = np.asarray(gnp.to_np(zi), dtype=float).reshape(-1)
    _n, d = xi.shape
    bounds = []
    for _ in range(int(mean_paramlength)):
        bounds.append((-np.inf, np.inf))
    emp_var = float(np.var(zi))
    bounds.append(
        (np.log(var_lower_factor * emp_var), np.log(var_upper_factor * emp_var))
    )
    for j in range(d):
        min_gap = _minimum_nonzero_gap_distance_1d(xi[:, j])
        if np.isfinite(min_gap):
            rho_lower = length_lower_factor * min_gap
            bounds.append((-np.inf, -np.log(rho_lower)))
        else:
            bounds.append((-np.inf, np.inf))
    return gnp.asarray(np.asarray(bounds, dtype=float))
