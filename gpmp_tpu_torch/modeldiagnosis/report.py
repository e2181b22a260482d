# gpmp_tpu_torch/modeldiagnosis/report.py
"""Model diagnosis report.

API parity surface: ``modeldiagnosis_init`` / ``model_diagnosis_disp`` /
``diag`` (reference gpmp/modeldiagnosis/report.py:37-256).  The report has
three sections: an optimizer-run summary, a parameter table (a
:class:`~gpmp_tpu_torch.parameter.Param` with the optimizer's box bounds mapped
back onto the covariance entries), and a data summary whose last column
rescales each coordinate by the fitted correlation lengths.
"""

from typing import Any, Dict, Optional

import numpy as np

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.parameter import (
    param_from_covparam_anisotropic,
    param_from_covparam_anisotropic_noisy,
)
from .utils import describe_array, pretty_print_dictionnary

_PARAM_FACTORIES = {
    "linear_mean_matern_anisotropic": param_from_covparam_anisotropic,
    "linear_mean_matern_anisotropic_noisy": param_from_covparam_anisotropic_noisy,
}


def _to_flat_np(x) -> np.ndarray:
    return np.asarray(gnp.to_np(gnp.asarray(x)), dtype=float).reshape(-1)


def _selection_summary(info) -> Dict[str, Any]:
    """Condense an optimizer info record into the printed summary fields."""
    summary = dict(
        cvg_reached=info.success,
        optimal_val=info.best_value_returned,
        n_evals=info.nfev,
        time=info.total_time,
        initial_val=info.selection_criterion(info.initial_params),
        final_val=info.fun,
    )
    return summary


def _covparam_bound_slice(model, info) -> Optional[np.ndarray]:
    """Extract the (cov_len, 2) slice of optimizer bounds that corresponds to
    the covariance parameters, or None when ``info`` carries no usable bounds.

    The optimizer's parameter vector is laid out [meanparam..., covparam...],
    so the covariance block starts after the mean parameters.
    """
    raw = getattr(info, "bounds", None)
    if raw is None:
        return None
    raw = np.asarray(raw, dtype=float)
    mean = getattr(model, "meanparam", None)
    n_mean = 0 if mean is None else _to_flat_np(mean).size
    n_cov = _to_flat_np(model.covparam).size
    usable = raw.ndim == 2 and raw.shape[1] == 2 and raw.shape[0] >= n_mean + n_cov
    if not usable:
        return None
    return raw[n_mean : n_mean + n_cov]


def _project_bounds(param_obj, cov_bounds: np.ndarray):
    """Write optimizer box bounds onto the Param entries tagged 'covparam'.

    A (-inf, inf) pair means unconstrained and is stored as None.  If the
    number of covparam-tagged entries disagrees with the bound rows, the
    Param is left untouched (mixed custom parameterizations).
    """
    targets = [
        idx for idx, path in enumerate(param_obj.paths)
        if path and path[0] == "covparam"
    ]
    if len(targets) != cov_bounds.shape[0]:
        return param_obj
    for idx, row in zip(targets, cov_bounds):
        lo, hi = float(row[0]), float(row[1])
        unbounded = np.isinf(lo) and np.isinf(hi)
        param_obj.bounds[idx] = None if unbounded else (lo, hi)
    return param_obj


def modeldiagnosis_init(model, info, *, model_type="linear_mean_matern_anisotropic",
                        param_obj=None) -> Dict[str, Any]:
    """Build the diagnosis dict: selection summary plus a Param table with
    optimizer bounds projected onto the covariance entries."""
    if param_obj is None:
        try:
            make_param = _PARAM_FACTORIES[model_type]
        except KeyError:
            raise ValueError(f"Unknown model type: {model_type}") from None
        covparam = _to_flat_np(model.covparam)
        param_obj = make_param(covparam, None, None, name_prefix="")

    cov_bounds = _covparam_bound_slice(model, info)
    if cov_bounds is not None:
        param_obj = _project_bounds(param_obj, cov_bounds)

    return {
        "optim_info": info,
        "param_selection": _selection_summary(info),
        "parameters": param_obj.to_simple_dict(),
        "param_obj": param_obj,
        "loo": {},
        "data": {},
    }


def _indent(text: str, pad: str = "    ") -> str:
    return "\n".join(pad + line for line in text.splitlines())


def model_diagnosis_disp(md, xi, zi, *,
                         model_type="linear_mean_matern_anisotropic") -> None:
    """Print the report: selection summary, Param table, and a data
    description whose delta column divides by the fitted lengthscales."""
    del model_type  # layout is inferred from the Param object
    xi = np.asarray(gnp.to_np(gnp.asarray(xi)))
    zi = np.asarray(gnp.to_np(gnp.asarray(zi)))

    print("[Model diagnosis]")
    print("  * Parameter selection")
    pretty_print_dictionnary(md["param_selection"])

    print("  * Parameters")
    print(_indent(str(md["param_obj"])))

    print("  * Data")
    print("    {:>0}: {:d}".format("count", int(zi.shape[0])))
    print("    -----")

    # Param convention: first entry is sigma2, last d entries are the
    # inverse-lengthscale exponents; describe_array's scale column divides
    # observations by sigma2 and coordinates by the lengthscales.
    fitted = np.fromiter(md["parameters"].values(), dtype=float)
    if zi.ndim == 1:
        z_rows = ["zi"]
    else:
        z_rows = [f"zi_{j}" for j in range(int(zi.shape[1]))]
    z_table = describe_array(zi, z_rows, 1.0 / fitted[0])

    dim = int(xi.shape[1])
    x_table = describe_array(xi, [f"xi_{j}" for j in range(dim)],
                             1.0 / fitted[-dim:])
    print(z_table.concat(x_table))


def diag(model, info_select_parameters, xi, zi, *,
         model_type="linear_mean_matern_anisotropic", param_obj=None) -> None:
    """Build and display a model diagnosis report."""
    report = modeldiagnosis_init(
        model, info_select_parameters, model_type=model_type, param_obj=param_obj
    )
    model_diagnosis_disp(report, xi, zi, model_type=model_type)


__all__ = ["modeldiagnosis_init", "model_diagnosis_disp", "diag"]
