# gpmp_tpu_torch/modeldiagnosis/plotting.py
"""Plotting helpers for model diagnosis (matplotlib, host-side).

Counterpart of gpmp_tpu/modeldiagnosis/plotting.py (semantics of
gpmp/modeldiagnosis/plotting.py:41-403).  Criterion profiles (1-D
cross-sections and the n x n 2-D profile) go through the criterion
wrapper's ``evaluate_batch`` when it has one.  Importing this module
imports matplotlib; ``gpmp_tpu_torch.modeldiagnosis`` imports it only when
one of these functions is asked for.
"""

import math
import sys
import time
from typing import Any, Optional, Sequence, Tuple

import numpy as np

import gpmp_tpu_torch.num as gnp

import matplotlib

if not hasattr(sys, "ps1"):
    try:
        matplotlib.get_backend()
    except Exception:
        matplotlib.use("Agg")
import matplotlib.pyplot as plt


def _batch_eval(criterion, P):
    """Evaluate criterion over an (m, p) stack, vectorized when possible."""
    be = getattr(getattr(criterion, "__self__", None), "evaluate_batch", None)
    if be is not None:
        return np.asarray(be(P))
    return np.array([float(criterion(p)) for p in P])


def plot_pit_ecdf(pit, fig=None) -> None:
    """Empirical CDF of PIT values against the uniform diagonal."""
    pit = np.asarray(gnp.to_np(gnp.asarray(pit))).reshape(-1)
    n = pit.shape[0]
    p = np.concatenate(([0.0], np.linspace(0.0, 1.0, n)))
    pit_sorted = np.concatenate(([0.0], np.sort(pit)))
    if fig is None:
        plt.figure()
    plt.step(pit_sorted, p)
    plt.plot([0.0, 1.0], [0.0, 1.0])
    plt.title("PIT ECDF")
    plt.xlabel("PIT")
    plt.ylabel("ECDF")
    plt.show()


def plot_selection_criterion_crosssections(
    *,
    info=None,
    selection_criterion=None,
    selection_criteria=None,
    covparam=None,
    n_points=100,
    param_names=None,
    criterion_name="selection criterion",
    criterion_names=None,
    criterion_name_full="Cross sections of selection criterion",
    ind=None,
    ind_pooled=None,
    param_box=None,
    param_box_pooled=None,
    delta=5.0,
) -> None:
    """1-D cross sections of one or several selection criteria around the
    reference parameter vector."""
    if hasattr(sys, "ps1") or sys.flags.interactive:
        plt.ion()

    if selection_criteria is None:
        if selection_criterion is None:
            if info is None:
                raise ValueError(
                    "Provide info or selection_criterion/selection_criteria."
                )
            selection_criterion = info.selection_criterion_nograd
        selection_criteria = (selection_criterion,)
    else:
        selection_criteria = tuple(selection_criteria)

    n_crit = len(selection_criteria)
    if criterion_names is None:
        criterion_names = (
            (criterion_name,)
            if n_crit == 1
            else tuple(f"{criterion_name} #{k}" for k in range(n_crit))
        )
    if len(criterion_names) != n_crit:
        raise ValueError("criterion_names length must match number of criteria.")

    if info is None:
        if covparam is None:
            raise ValueError("covparam must be supplied when info is None.")
        param_opt = np.asarray(gnp.to_np(gnp.asarray(covparam))).reshape(-1)
    else:
        src = covparam if covparam is not None else info.covparam
        param_opt = np.asarray(gnp.to_np(gnp.asarray(src))).reshape(-1)

    n_params = param_opt.shape[0]
    if ind is None and ind_pooled is None:
        ind = list(range(n_params))

    def _grid(param_index, opt_val, box):
        if box is not None:
            lo = float(np.asarray(box)[0, param_index])
            hi = float(np.asarray(box)[1, param_index])
        else:
            lo, hi = float(opt_val) - delta, float(opt_val) + delta
        return np.linspace(lo, hi, n_points)

    def _profiles(param_idx, p_values):
        P = np.tile(param_opt, (len(p_values), 1))
        P[:, param_idx] = p_values
        return np.stack([_batch_eval(f, P) for f in selection_criteria])

    if ind is not None:
        ind = list(ind)
        n_ind = len(ind)
        fig, axes = plt.subplots(n_ind, 1, figsize=(8, min(9, 3 * n_ind)))
        if n_ind == 1:
            axes = [axes]
        for ax_i, param_idx in enumerate(ind):
            opt_value = param_opt[param_idx]
            p_values = _grid(ax_i, opt_value, param_box)
            crit_values = _profiles(param_idx, p_values)
            ax = axes[ax_i]
            for k in range(n_crit):
                ax.plot(p_values, crit_values[k], label=criterion_names[k])
            ax.axvline(float(opt_value), color="red", linestyle="--",
                       label="reference")
            name = (
                param_names[param_idx]
                if param_names is not None and param_idx < len(param_names)
                else f"param {param_idx}"
            )
            ax.set_title(name)
            ax.set_ylabel("criterion value")
            if ax_i == n_ind - 1:
                ax.set_xlabel("parameter value")
            if ax_i == 0:
                ax.legend()
        fig.suptitle(criterion_name_full, fontsize=12)
        plt.tight_layout(rect=[0, 0, 1, 0.95])
        plt.show()

    if ind_pooled is not None:
        ind_pooled = list(ind_pooled)
        fig, ax = plt.subplots(figsize=(8, 6))
        for i, param_idx in enumerate(ind_pooled):
            opt_value = param_opt[param_idx]
            p_values = _grid(i, opt_value, param_box_pooled)
            crit_values = _profiles(param_idx, p_values)
            name = (
                param_names[param_idx]
                if param_names is not None and param_idx < len(param_names)
                else f"param {param_idx}"
            )
            for k in range(n_crit):
                ax.plot(p_values, crit_values[k],
                        label=f"{name} - {criterion_names[k]}")
            ax.axvline(float(opt_value), color="red", linestyle="--")
        ax.set_xlabel("parameter value")
        ax.set_ylabel("criterion value")
        ax.set_title(criterion_name_full)
        ax.legend()
        plt.tight_layout()
        plt.show()


def plot_selection_criterion_2d(
    model,
    info,
    *,
    param_indices: Tuple[int, int] = (0, 1),
    param_names=None,
    criterion_name="selection criterion",
    n=130,
    factor=4.0,
    shift_criterion=True,
) -> None:
    """2-D criterion profile over two parameters on a log10 (sigma, rho)
    grid; one vectorized evaluation of the n x n grid."""
    tic = time.time()
    print(f"  ***  Computing {criterion_name} profile for plotting...")

    i1, i2 = param_indices
    cov0 = np.asarray(gnp.to_np(gnp.asarray(model.covparam))).reshape(-1)

    p1_0 = math.exp(cov0[i1] / 2.0) if i1 == 0 else math.exp(-cov0[i1])
    p2_0 = math.exp(cov0[i2] / 2.0) if i2 == 0 else math.exp(-cov0[i2])

    p1 = np.logspace(math.log10(p1_0) - math.log10(factor),
                     math.log10(p1_0) + math.log10(factor), n)
    p2 = np.logspace(math.log10(p2_0) - math.log10(factor),
                     math.log10(p2_0) + math.log10(factor), n)
    p1_mesh, p2_mesh = np.meshgrid(p1, p2)
    log_p1 = np.log(p1_mesh**2) if i1 == 0 else np.log(1.0 / p1_mesh)
    log_p2 = np.log(p2_mesh**2) if i2 == 0 else np.log(1.0 / p2_mesh)

    f = info.selection_criterion_nograd
    base = np.asarray(gnp.to_np(gnp.asarray(info.covparam))).reshape(-1)
    P = np.tile(base, (n * n, 1))
    P[:, i1] = log_p1.ravel()
    P[:, i2] = log_p2.ravel()
    values = _batch_eval(f, P).reshape(n, n)
    values = np.nan_to_num(values)
    elapsed = time.time() - tic
    print(f"       {n * n} evaluations in {elapsed:.3f}s")

    shift = -float(np.min(values)) if shift_criterion else 0.0
    z = np.log10(np.maximum(1e-2, values + shift))

    plt.figure()
    plt.contourf(np.log10(p1_mesh), np.log10(p2_mesh), z)

    def _disp_coords(cp):
        x = 0.5 * np.log10(np.exp(cp[i1])) if i1 == 0 else -np.log10(np.exp(cp[i1]))
        y = 0.5 * np.log10(np.exp(cp[i2])) if i2 == 0 else -np.log10(np.exp(cp[i2]))
        return x, y

    plt.plot(*_disp_coords(base), "ro")
    cov0_disp = getattr(info, "covparam0", None)
    if cov0_disp is not None:
        plt.plot(*_disp_coords(np.asarray(cov0_disp).reshape(-1)), "bo")

    if param_names is not None and len(param_names) >= 2:
        x_label, y_label = param_names[0], param_names[1]
    else:
        x_label, y_label = f"Parameter {i1} (log10)", f"Parameter {i2} (log10)"
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.title(
        "log10 of " + ("shifted " if shift_criterion else "") + str(criterion_name)
    )
    plt.colorbar()
    plt.show()


def plot_selection_criterion_sigma_rho(
    model, info, *, criterion_name="negative log restricted likelihood",
    n=130, factor=4.0, shift_criterion=True,
) -> None:
    """2-D profile over (sigma, rho) = indices (0, 1)."""
    plot_selection_criterion_2d(
        model,
        info,
        param_indices=(0, 1),
        param_names=("sigma (log10)", "rho (log10)"),
        criterion_name=criterion_name,
        n=n,
        factor=factor,
        shift_criterion=shift_criterion,
    )


__all__ = [
    "plot_pit_ecdf",
    "plot_selection_criterion_crosssections",
    "plot_selection_criterion_2d",
    "plot_selection_criterion_sigma_rho",
]
