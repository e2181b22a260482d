# gpmp_tpu_torch/kernel/parameter_selection.py
"""Selection criteria + the SciPy optimization loop.

Counterpart of gpmp_tpu/kernel/parameter_selection.py.  The criterion and
its gradient come from one forward and one ``torch.autograd.grad``
(gnp.DifferentiableSelectionCriterion); SciPy SLSQP / L-BFGS-B runs on the
host.  History recording, local bounds and the best-seen fallback follow
the JAX package.

Mesh mode (``mesh=``, ``shard_block=``, ``init_subsample=``) takes the
port's one-card mesh (gpmp_tpu_torch.parallel.make_mesh): the model is
wrapped in ``parallel.ShardedModelView`` (panel size ``shard_block``) and
its REML runs on the mesh's resident branch or, past the resident engines'
memory, on the streamed engine.

Not ported yet (ROADMAP): dataloader sources, ``method='lbfgs-device'``,
meshes of more than one card, REMAP and priors.
"""

import time

import numpy as np
import torch
from scipy.optimize import minimize

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.config import get_logger
from .init import (
    anisotropic_parameters_initial_guess,
    anisotropic_parameters_initial_guess_constant_mean,
)
from .utils import check_xi_zi_or_loader


def _not_ported(what, item):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item {item})")


def _check_unported(method=None, mesh=None):
    if method == "lbfgs-device":
        _not_ported("method='lbfgs-device'", 5)
    if mesh is not None:
        from gpmp_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh) or mesh.size != 1:
            _not_ported("mesh mode beyond the port's one-card mesh (parallel.make_mesh(1))", 11)


# ---------------------- criterion + gradient maker --------------------
def make_selection_criterion_with_gradient(
    model,
    selection_criterion,
    xi=None,
    zi=None,
    dataloader=None,
    batches_per_eval=0,
    parameterized_mean=False,
    meanparam_len=1,
):
    """Build the 4-callable optimizer protocol from a criterion function.

    criterion signatures: f(model, covparam, xi, zi), or
    f(model, meanparam, covparam, xi, zi) when parameterized_mean=True
    (the optimization vector is then [meanparam, covparam]).

    Returns (evaluate, evaluate_pre_grad, evaluate_no_grad, gradient).
    """
    check_xi_zi_or_loader(xi, zi, dataloader)

    if parameterized_mean:

        def crit_(param, xi_, zi_):
            meanparam = param[:meanparam_len]
            covparam = param[meanparam_len:]
            return selection_criterion(model, meanparam, covparam, xi_, zi_)

    else:

        def crit_(covparam, xi_, zi_):
            return selection_criterion(model, covparam, xi_, zi_)

    crit = gnp.DifferentiableSelectionCriterion(crit_, xi, zi)
    return crit.evaluate, crit.evaluate_pre_grad, crit.evaluate_no_grad, crit.gradient


# ------------------------------ optimizer -----------------------------
def autoselect_parameters(
    p0,
    criterion,
    gradient,
    bounds=None,
    bounds_auto=True,
    bounds_delta=10.0,
    silent=True,
    info=False,
    method="SLSQP",
    method_options=None,
):
    """Minimize a scalar criterion with SciPy ('SLSQP' or 'L-BFGS-B').

    - automatic local bounds p0 +- bounds_delta clipped to [-500, 500];
    - full history recording (params + criterion values);
    - best-seen fallback when the final SciPy iterate is worse;
    - linalg failures map to +inf so optimization continues.

    Returns (p_opt, OptimizeResult-or-None).
    """
    _check_unported(method=method)
    if method_options is None:
        method_options = {}
    tic = time.time()

    safe_lower, safe_upper = -500, 500
    if bounds is None and bounds_auto:
        bounds = [
            (
                max(float(param) - bounds_delta, safe_lower),
                min(float(param) + bounds_delta, safe_upper),
            )
            for param in np.asarray(p0)
        ]

    history_params, history_criterion = [], []
    best_params, best_criterion = None, float("inf")

    def record(p, J):
        nonlocal best_params, best_criterion
        history_params.append(np.array(p, copy=True))
        history_criterion.append(J)
        if J < best_criterion:
            best_criterion, best_params = J, np.array(p, copy=True)

    warned_initial_inf = False

    def criterion_with_history(p):
        nonlocal warned_initial_inf
        try:
            J = float(criterion(p))
        except Exception as exc:
            if gnp._is_linalg_exception(exc):
                J = np.inf
            else:
                raise
        if (
            not warned_initial_inf
            and not history_criterion
            and not np.isfinite(J)
        ):
            warned_initial_inf = True
            get_logger().warning(
                "Selection criterion is +inf at the initial point "
                "(covariance not factorizable there: likely an "
                "ill-conditioned noise-free kernel or a bad covparam0); "
                "the optimizer cannot make progress from +inf. Consider "
                "an observation-noise term or a better covparam0."
            )
        record(p, J)
        return J

    def gradient_np(p):
        return np.asarray(gradient(p), dtype=float)

    options = {} if method == "L-BFGS-B" else {"disp": not silent}
    if method == "L-BFGS-B":
        options.update(
            dict(
                maxcor=20, ftol=1e-6, gtol=1e-5, eps=1e-8,
                maxfun=15000, maxiter=15000, maxls=40,
            )
        )
    elif method == "SLSQP":
        options.update(dict(ftol=1e-6, eps=1e-8, maxiter=15000))
    else:
        raise ValueError("Optimization method not implemented.")
    options.update(method_options)

    r = minimize(
        criterion_with_history,
        np.asarray(p0, dtype=float),
        method=method,
        jac=gradient_np,
        bounds=bounds,
        options=options,
    )

    if r.fun > best_criterion:
        r.x, r.fun, r.best_value_returned = best_params, best_criterion, False
    else:
        r.best_value_returned = True

    r.history_params = history_params
    r.history_criterion = history_criterion
    r.initial_params = np.asarray(p0, dtype=float)
    r.final_params = r.x
    r.bounds = bounds
    r.selection_criterion = criterion
    r.total_time = time.time() - tic

    return (r.x, r) if info else (r.x, None)


# -------------------- high-level selection procedures ------------
def _subsampled_initial_guess(model, xi, zi, init_subsample):
    """Dense init heuristic on a deterministic subsample (mesh mode)."""
    xi_, zi_ = gnp.asarray(xi), gnp.asarray(zi)
    n = xi_.shape[0]
    m = min(int(init_subsample), n)
    idx = torch.as_tensor(np.random.default_rng(0).permutation(n)[:m], device=xi_.device)
    return anisotropic_parameters_initial_guess(model, xi_[idx], zi_[idx].reshape(-1))


def select_parameters_with_criterion(
    model,
    criterion,
    xi=None,
    zi=None,
    dataloader=None,
    meanparam0=None,
    covparam0=None,
    parameterized_mean=False,
    meanparam_len=1,
    info=False,
    verbosity=0,
    *,
    bounds=None,
    bounds_auto=True,
    bounds_delta=10.0,
    batches_per_eval=0,
    method="SLSQP",
    method_options=None,
    mesh=None,
    shard_block=None,
    init_subsample=2048,
):
    """Optimize model parameters under a user-supplied criterion;
    writes the optimum back into the model.  With info=True, returns a
    diagnostics dict with history/timing/criterion callables.

    Mesh mode: pass the port's one-card mesh (``parallel.make_mesh(1)``)
    and the model is wrapped in ``parallel.ShardedModelView`` (panel size
    ``shard_block``, default auto_shard_block), so a criterion built on the
    model's likelihood methods runs on the mesh's resident branch or the
    streamed large-n engine.  When ``covparam0`` is None, the init
    heuristic runs on a deterministic subsample of ``init_subsample`` points
    (the dense heuristic would build the full gram)."""
    _check_unported(method=method, mesh=mesh)
    if method_options is None:
        method_options = {}

    tic = time.time()
    check_xi_zi_or_loader(xi, zi, dataloader)

    base_model = model
    if mesh is not None:
        from gpmp_tpu_torch.parallel.view import ShardedModelView

        model = ShardedModelView(base_model, mesh, block=shard_block)
        if covparam0 is None:
            covparam0 = _subsampled_initial_guess(base_model, xi, zi, init_subsample)

    if covparam0 is None:
        covparam0 = anisotropic_parameters_initial_guess(model, xi, zi)

    if parameterized_mean:
        if meanparam0 is None:
            raise ValueError("meanparam0 must be provided when parameterized_mean=True.")
        param0 = gnp.concatenate([gnp.asarray(meanparam0), gnp.asarray(covparam0)])
    else:
        param0 = covparam0

    crit, crit_pre_grad, crit_no_grad, crit_grad = (
        make_selection_criterion_with_gradient(
            model,
            criterion,
            xi,
            zi,
            batches_per_eval=batches_per_eval,
            parameterized_mean=parameterized_mean,
            meanparam_len=meanparam_len,
        )
    )

    silent = not (verbosity == 2)
    if verbosity == 1:
        print("Parameter selection using custom criterion...")

    param_opt, info_ret = autoselect_parameters(
        gnp.to_np(gnp.asarray(param0)),
        crit_pre_grad,
        crit_grad,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        silent=silent,
        info=True,
        method=method,
        method_options=method_options,
    )

    if verbosity == 1:
        print("done.")

    if parameterized_mean:
        meanparam_opt = param_opt[:meanparam_len]
        covparam_opt = param_opt[meanparam_len:]
        model.meanparam = gnp.asarray(meanparam_opt)
    else:
        meanparam_opt = None
        covparam_opt = param_opt
    model.covparam = gnp.asarray(covparam_opt)

    if info:
        info_ret["meanparam0"] = (
            gnp.to_np(gnp.asarray(meanparam0)) if parameterized_mean else None
        )
        info_ret["covparam0"] = gnp.to_np(gnp.asarray(covparam0))
        info_ret["meanparam"] = meanparam_opt
        info_ret["covparam"] = covparam_opt
        info_ret["selection_criterion"] = crit
        info_ret["selection_criterion_nograd"] = crit_no_grad
        info_ret["time"] = time.time() - tic
        return base_model, info_ret
    return base_model, None


def update_parameters_with_criterion(
    model,
    criterion,
    xi=None,
    zi=None,
    dataloader=None,
    parameterized_mean=False,
    meanparam_len=1,
    info=False,
    *,
    bounds=None,
    bounds_auto=True,
    bounds_delta=10.0,
    method="SLSQP",
    method_options=None,
    mesh=None,
    shard_block=None,
):
    """Re-optimize from the current model parameters."""
    return select_parameters_with_criterion(
        model,
        criterion,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        meanparam0=model.meanparam if parameterized_mean else None,
        covparam0=model.covparam,
        parameterized_mean=parameterized_mean,
        meanparam_len=meanparam_len,
        info=info,
        verbosity=0,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
        mesh=mesh,
        shard_block=shard_block,
    )


# ------------------------- objective wrappers -------------------------
def negative_log_likelihood_zero_mean(model, covparam, xi, zi):
    """ML criterion for zero-mean models."""
    return model.negative_log_likelihood_zero_mean(covparam, xi, zi)


def negative_log_likelihood(model, meanparam, covparam, xi, zi):
    """ML criterion with mean parameters."""
    return model.negative_log_likelihood(meanparam, covparam, xi, zi)


def negative_log_restricted_likelihood(model, covparam, xi, zi):
    """REML criterion."""
    return model.negative_log_restricted_likelihood(covparam, xi, zi)


# --------------------------- ML constant mean ---------------------------
def select_parameters_with_ml_constant_mean(
    model,
    xi=None,
    zi=None,
    dataloader=None,
    meanparam0=None,
    covparam0=None,
    info=False,
    verbosity=0,
    *,
    bounds=None,
    bounds_auto=True,
    bounds_delta=10.0,
    method="SLSQP",
    method_options=None,
):
    """Joint ML over [constant meanparam, covparam]
    (model.meantype must be 'parameterized')."""
    if getattr(model, "meantype", None) != "parameterized":
        raise ValueError(
            "select_parameters_with_ml_constant_mean requires a model with "
            "meantype='parameterized'."
        )

    if meanparam0 is None or covparam0 is None:
        meanparam0_guess, covparam0_guess = (
            anisotropic_parameters_initial_guess_constant_mean(model, xi, zi, dataloader)
        )
        if meanparam0 is None:
            meanparam0 = meanparam0_guess
        if covparam0 is None:
            covparam0 = covparam0_guess

    meanparam0 = gnp.asarray(meanparam0).reshape(-1)
    if int(meanparam0.shape[0]) != 1:
        raise ValueError("meanparam0 must contain exactly one constant-mean parameter.")
    covparam0 = gnp.asarray(covparam0).reshape(-1)

    return select_parameters_with_criterion(
        model,
        negative_log_likelihood,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        meanparam0=meanparam0,
        covparam0=covparam0,
        parameterized_mean=True,
        meanparam_len=1,
        info=info,
        verbosity=verbosity,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
    )


def update_parameters_with_ml_constant_mean(
    model, xi=None, zi=None, dataloader=None, info=False, *,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
):
    return select_parameters_with_ml_constant_mean(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        meanparam0=model.meanparam,
        covparam0=model.covparam,
        info=info,
        verbosity=0,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
    )


# --------------------------------- REML ---------------------------------
def _reml_criterion(m, covparam, x, z):
    """REML criterion routed through the model method."""
    return m.negative_log_restricted_likelihood(covparam, x, z)


def select_parameters_with_reml(
    model, xi=None, zi=None, dataloader=None, covparam0=None, info=False,
    verbosity=0, *,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
    mesh=None, shard_block=None, init_subsample=2048,
):
    """Select covariance parameters with REML.

    Large-n mode: pass the port's one-card mesh (``parallel.make_mesh(1)``)
    and the criterion becomes
    ``parallel.sharded_negative_log_restricted_likelihood`` (the resident
    branch with panels of ``shard_block``, or the streamed engine); with
    ``covparam0`` None the init heuristic runs on a deterministic subsample
    of ``init_subsample`` points."""
    return select_parameters_with_criterion(
        model,
        _reml_criterion,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        info=info,
        verbosity=verbosity,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
        mesh=mesh,
        shard_block=shard_block,
        init_subsample=init_subsample,
    )


def update_parameters_with_reml(
    model, xi=None, zi=None, dataloader=None, info=False, *,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
    mesh=None, shard_block=None,
):
    return update_parameters_with_criterion(
        model,
        _reml_criterion,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        info=info,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
        mesh=mesh,
        shard_block=shard_block,
    )
