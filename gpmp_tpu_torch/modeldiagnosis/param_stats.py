# gpmp_tpu_torch/modeldiagnosis/param_stats.py
"""Parameter statistics from 1-D criterion profiles.

Counterpart of gpmp_tpu/modeldiagnosis/param_stats.py (semantics of
gpmp/modeldiagnosis/param_stats.py:61-372).  Grid profiles go through the
criterion wrapper's ``evaluate_batch`` when it has one: the grid's values
come back to the host in one transfer.
"""

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
from scipy.integrate import cumulative_trapezoid
from scipy.optimize import minimize_scalar

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.misc.dataframe import DataFrame
from .un1ddist import Unnormalized1DDistribution


def _to_float(x) -> float:
    if hasattr(x, "item"):
        try:
            return float(x.item())
        except Exception:
            pass
    return float(x)


def _stats_from_grid(xs, vals):
    """Weighted stats with pseudo density w = exp(-vals), grid-based."""
    vals = np.asarray(vals, dtype=float)
    vals = np.where(np.isfinite(vals), vals, np.inf)  # NaN from failed chol
    logw = -vals
    logw -= np.max(logw[np.isfinite(logw)]) if np.isfinite(logw).any() else 0.0
    w = np.exp(logw)
    Z = np.trapezoid(w, xs)
    if not np.isfinite(Z) or Z <= 0.0:
        raise ValueError("Normalization failed in fast_univariate_stats.")
    mean_val = float(np.trapezoid(xs * w, xs) / Z)
    second = float(np.trapezoid(xs**2 * w, xs) / Z)
    variance = second - mean_val**2
    cdf = cumulative_trapezoid(w, xs, initial=0.0) / Z
    quantiles = {str(q): float(np.interp(q, cdf, xs)) for q in
                 (0.1, 0.25, 0.5, 0.75, 0.9)}
    mode_val = float(xs[int(np.argmax(w))])
    return mean_val, variance, quantiles, mode_val


def fast_univariate_stats(single_param_fn, lower_bound, upper_bound,
                          n_points=100):
    """Grid mean/variance/quantiles/mode of w(x) = exp(-f(x))."""
    xs = np.linspace(float(lower_bound), float(upper_bound), int(n_points))
    vals = np.array([_to_float(single_param_fn(float(x))) for x in xs])
    return _stats_from_grid(xs, vals)


def make_single_param_criterion_function(selection_criterion, covparam,
                                         param_index):
    """g(x) = f(covparam with entry param_index set to x)."""
    covparam_ref = np.asarray(gnp.to_np(gnp.asarray(covparam))).copy()

    def single_param_function(x):
        cp = covparam_ref.copy()
        cp[param_index] = x
        return selection_criterion(cp)

    return single_param_function


def _resolve_from_info(info, selection_criterion, covparam, model, xi):
    if info is not None:
        if selection_criterion is None:
            selection_criterion = (
                info["selection_criterion_nograd"]
                if isinstance(info, dict)
                else info.selection_criterion_nograd
            )
        if covparam is None:
            covparam = info["covparam"] if isinstance(info, dict) else info.covparam
        if model is None and hasattr(info, "model"):
            model = info.model
        if xi is None and hasattr(info, "xi"):
            xi = info.xi
    if selection_criterion is None:
        raise ValueError("selection_criterion is required.")
    if covparam is None:
        raise ValueError("covparam is required.")
    if model is None:
        raise ValueError("model is required.")
    if xi is None:
        raise ValueError("xi is required.")
    return selection_criterion, covparam, model, xi


_COLS = [
    "mean", "variance", "quantile_0.1", "quantile_0.25", "quantile_0.5",
    "quantile_0.75", "quantile_0.9", "mode",
]


def selection_criterion_statistics_fast(
    info=None, model=None, xi=None, selection_criterion=None, covparam=None,
    ind=None, param_box=None, delta=5.0, n_points=250, verbose=False,
) -> Dict[str, Any]:
    """Grid-based per-parameter statistics + Fisher information.

    When the criterion exposes ``evaluate_batch``
    (gnp.DifferentiableSelectionCriterion), each parameter profile goes
    through it: one criterion call per row, the values read back in one
    transfer.
    """
    selection_criterion, covparam, model, xi = _resolve_from_info(
        info, selection_criterion, covparam, model, xi
    )
    covparam = np.asarray(gnp.to_np(gnp.asarray(covparam))).reshape(-1)
    n_params = covparam.shape[0]
    ind_list = list(range(n_params)) if ind is None else [int(i) for i in ind]
    box = None if param_box is None else np.asarray(param_box, dtype=float)

    batch_eval = getattr(
        getattr(selection_criterion, "__self__", None), "evaluate_batch", None
    )

    rows, row_names = [], []
    for j in ind_list:
        opt = float(covparam[j])
        lo, hi = (
            (float(box[0, j]), float(box[1, j]))
            if box is not None
            else (opt - delta, opt + delta)
        )
        xs = np.linspace(lo, hi, int(n_points))
        if batch_eval is not None:
            P = np.tile(covparam, (len(xs), 1))
            P[:, j] = xs
            vals = batch_eval(P)
        else:
            sp = make_single_param_criterion_function(selection_criterion,
                                                      covparam, j)
            vals = np.array([_to_float(sp(float(x))) for x in xs])
        mean_val, var_val, q, mode_val = _stats_from_grid(xs, vals)
        if verbose:
            print(f"param {j}: mean={mean_val:.6g} var={var_val:.6g} "
                  f"mode={mode_val:.6g}")
        rows.append([mean_val, var_val, q["0.1"], q["0.25"], q["0.5"],
                     q["0.75"], q["0.9"], mode_val])
        row_names.append(f"param_{j:d}")

    stats_df = DataFrame(np.asarray(rows, dtype=float), _COLS, row_names)
    fisher = model.fisher_information(xi, covparam, epsilon=1e-3)
    return {"parameter_statistics": stats_df, "fisher_information": fisher}


def selection_criterion_statistics(
    info=None, model=None, xi=None, selection_criterion=None, covparam=None,
    ind=None, param_box=None, delta=5.0, verbose=False,
) -> Dict[str, Any]:
    """Integration-based (scipy.quad) per-parameter statistics + Fisher."""
    selection_criterion, covparam, model, xi = _resolve_from_info(
        info, selection_criterion, covparam, model, xi
    )
    covparam = np.asarray(gnp.to_np(gnp.asarray(covparam))).reshape(-1)
    n_params = covparam.shape[0]
    ind_list = list(range(n_params)) if ind is None else [int(i) for i in ind]
    box = None if param_box is None else np.asarray(param_box, dtype=float)

    rows, row_names = [], []
    for j in ind_list:
        opt = float(covparam[j])
        lo, hi = (
            (float(box[0, j]), float(box[1, j]))
            if box is not None
            else (opt - delta, opt + delta)
        )
        sp = make_single_param_criterion_function(selection_criterion, covparam, j)

        dist = Unnormalized1DDistribution(
            lambda x: -_to_float(sp(float(x))), bounds=(lo, hi)
        )
        res = minimize_scalar(lambda x: _to_float(sp(float(x))), bounds=(lo, hi),
                              method="bounded")
        mode_val = float(res.x) if getattr(res, "success", False) else opt

        if verbose:
            print(f"param {j}: mean={dist.mean():.6g} var={dist.var():.6g} "
                  f"mode={mode_val:.6g}")
        rows.append([
            dist.mean(), dist.var(), dist.quantile(0.1), dist.quantile(0.25),
            dist.quantile(0.5), dist.quantile(0.75), dist.quantile(0.9), mode_val,
        ])
        row_names.append(f"param_{j:d}")

    stats_df = DataFrame(np.asarray(rows, dtype=float), _COLS, row_names)
    fisher = model.fisher_information(xi, covparam, epsilon=1e-3)
    return {"parameter_statistics": stats_df, "fisher_information": fisher}


__all__ = [
    "fast_univariate_stats",
    "make_single_param_criterion_function",
    "selection_criterion_statistics_fast",
    "selection_criterion_statistics",
]
