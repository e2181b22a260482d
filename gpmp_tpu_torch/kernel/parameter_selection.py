# gpmp_tpu_torch/kernel/parameter_selection.py
"""Selection criteria + the optimization loops.

Counterpart of gpmp_tpu/kernel/parameter_selection.py.  The criterion and
its gradient come from one forward and one ``torch.autograd.grad``
(gnp.DifferentiableSelectionCriterion, or from a dataloader
gnp.BatchDifferentiableSelectionCriterion); SciPy SLSQP / L-BFGS-B runs on
the host.  History recording, local bounds and the best-seen fallback follow
the JAX package.  ``method='lbfgs-device'`` runs the whole L-BFGS fit on the
criterion's device instead (``_autoselect_parameters_on_device``).

The REMAP procedures (``select_/update_parameters_with_remap*``) bind their
prior hyperparameters into the criterion with ``functools.partial``; the
prior anchor, the optimizer start and the hyperparameters are resolved once,
on the host, before the fit (prior_helpers.py).

Mesh mode (``mesh=``, ``shard_block=``, ``init_subsample=``) takes a
mesh of gpmp_tpu_torch.parallel.make_mesh (one card, or the ranks of a
torch.distributed group): the model is wrapped in
``parallel.ShardedModelView`` (panel size ``shard_block``) and its REML runs
on the mesh's resident branch or, past the resident engines' memory on one
card, on the streamed engine.  On a group mesh every rank runs the same
SciPy loop on the same replicated criterion values, bitwise, so the ranks
take the same steps.
"""

import functools
import time

import numpy as np
import torch
from scipy.optimize import OptimizeResult, minimize

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.config import get_device, get_logger
from .init import (
    anisotropic_parameters_initial_guess,
    anisotropic_parameters_initial_guess_constant_mean,
)
from .prior_defaults import resolve_prior_defaults_for_selection
from .prior_helpers import (
    resolve_covparam0_prior_and_init,
    resolve_covparam0_roles_for_update,
    resolve_logsigma2_logrho_prior_args,
)
from .priors import (
    _check_logrho_support,
    neg_log_restricted_posterior_logsigma2_and_logrho_prior,
    neg_log_restricted_posterior_logsigma2_prior,
    neg_log_restricted_posterior_power_laws_prior,
)
from .utils import check_xi_zi_or_loader


def _check_mesh(mesh):
    if mesh is not None:
        from gpmp_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a gpmp_tpu_torch.parallel.make_mesh mesh; got "
                            f"{type(mesh).__name__}")


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
    data_source = check_xi_zi_or_loader(xi, zi, dataloader)

    if parameterized_mean:

        def crit_(param, xi_, zi_):
            meanparam = param[:meanparam_len]
            covparam = param[meanparam_len:]
            return selection_criterion(model, meanparam, covparam, xi_, zi_)

    else:

        def crit_(covparam, xi_, zi_):
            return selection_criterion(model, covparam, xi_, zi_)

    if data_source == "arrays":
        crit = gnp.DifferentiableSelectionCriterion(crit_, xi, zi)
    else:
        crit = gnp.BatchDifferentiableSelectionCriterion(
            crit_, dataloader, batches_per_eval=batches_per_eval
        )
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
    """Minimize a scalar criterion.

    method='SLSQP' / 'L-BFGS-B': SciPy on the host --
    - automatic local bounds p0 +- bounds_delta clipped to [-500, 500];
    - full history recording (params + criterion values);
    - best-seen fallback when the final SciPy iterate is worse;
    - linalg failures map to +inf so optimization continues.

    method='lbfgs-device': the whole L-BFGS fit on the criterion's device
    (``_autoselect_parameters_on_device``), the host reading the state back
    once per chunk of evaluations; the criterion must be one of
    make_selection_criterion_with_gradient's from arrays (or a function of a
    tensor returning a differentiable scalar tensor); no history beyond the
    start and the end is recorded.

    Returns (p_opt, OptimizeResult-or-None).
    """
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

    if method == "lbfgs-device":
        return _autoselect_parameters_on_device(
            p0, criterion, bounds, info=info,
            method_options=method_options, tic=tic
        )

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


def _traceable_criterion(criterion):
    """(theta -> J(theta), device): J a differentiable function of a tensor,
    recovered from a DifferentiableSelectionCriterion's bound method (its
    crit, x and z), or the criterion itself when it returns tensors."""
    wrapper = getattr(criterion, "__self__", None)
    if wrapper is not None and hasattr(wrapper, "crit") and hasattr(wrapper, "x"):
        fn, x, z = wrapper.crit, wrapper.x, wrapper.z
        return (lambda p: fn(p, x, z).reshape(())), x.device

    def fun(p):
        value = criterion(p)
        if not isinstance(value, torch.Tensor):
            raise TypeError(
                "method='lbfgs-device' needs a criterion that returns a tensor: one of "
                "make_selection_criterion_with_gradient's from arrays (xi, zi), or a "
                "function of a tensor returning a differentiable scalar")
        return value.reshape(())

    return fun, get_device()


_ARMIJO_C1 = 1e-4    # sufficient decrease of the backtracking line search
_BACKTRACK = 0.5     # step reduction after a rejected trial point
_CURVATURE = 1e-10   # a pair (s, y) enters the memory when s.y > this |s| |y|
_STALL = 1e-13       # a step shorter than this (1 + |x|) ends the search


def _lbfgs_direction(g, S, Y, rho):
    """-H g by the two-loop recursion over the memory (S, Y, rho), newest
    pair last; empty slots have rho = 0 and add nothing.  With an empty
    memory, -g scaled to length at most 1."""
    m = S.shape[0]
    q = g
    alphas = [None] * m
    for i in range(m - 1, -1, -1):
        alphas[i] = rho[i] * torch.dot(S[i], q)
        q = q - alphas[i] * Y[i]
    yy = torch.dot(Y[-1], Y[-1])
    gamma = torch.where(rho[-1] > 0, torch.dot(S[-1], Y[-1]) / torch.where(yy > 0, yy, 1.0),
                        1.0 / torch.clamp(torch.linalg.vector_norm(g), min=1.0))
    r = gamma * q
    for i in range(m):
        beta = rho[i] * torch.dot(Y[i], r)
        r = r + (alphas[i] - beta) * S[i]
    d = -r
    steepest = -g / torch.clamp(torch.linalg.vector_norm(g), min=1.0)
    return torch.where(torch.dot(g, d) < 0, d, steepest)


def _autoselect_parameters_on_device(p0, criterion, bounds, info=False,
                                     method_options=None, tic=None):
    """Whole L-BFGS fit on the criterion's device (see autoselect_parameters
    method='lbfgs-device').

    The JAX package runs optax's L-BFGS as jitted while_loop chunks.  Here
    each step of the loop is one criterion evaluation (value and gradient)
    at a trial point, written without host branches: the trial point
    x + t d, clipped to the bounds, is taken when it meets Armijo's
    condition (then (s, y) enters the memory of ``memory_size`` pairs when
    its curvature is positive, the direction is the two-loop recursion's,
    t = 1) and otherwise t is halved; once the gradient's norm is under
    ``gtol``, the step under the stall length or ``maxiter`` steps taken,
    the state stays as it is.  The host queues ``chunk_size`` evaluations
    and reads the state back once per chunk (steps taken, gradient norm,
    value, the end flag), and stops on the end flag, on a non-finite value,
    or when a chunk improves the value by at most ``ftol * chunk_size *
    max(|J|, |J_prev|, 1)`` (the JAX package's stopping rules).  The end
    point falls back to p0 when it is worse.
    """
    opts = dict(maxiter=200, gtol=1e-5, ftol=1e-6, memory_size=20, chunk_size=25)
    opts.update(method_options or {})
    fun, device = _traceable_criterion(criterion)
    dtype = gnp.get_dtype()
    p0 = np.asarray(p0, dtype=float)
    x = torch.as_tensor(p0, dtype=dtype, device=device)
    lb = ub = None
    if bounds is not None:
        lb = torch.as_tensor([b[0] for b in bounds], dtype=dtype, device=device)
        ub = torch.as_tensor([b[1] for b in bounds], dtype=dtype, device=device)

    def value_and_grad(p):
        p = p.detach().requires_grad_(True)
        value = fun(p)
        (g,) = torch.autograd.grad(value, p)
        return value.detach(), g

    maxiter = int(opts["maxiter"])
    gtol, ftol = float(opts["gtol"]), float(opts["ftol"])
    m = int(opts["memory_size"])
    chunk = max(1, int(opts["chunk_size"]))
    S = torch.zeros((m, x.shape[0]), dtype=dtype, device=device)
    Y = torch.zeros_like(S)
    rho = torch.zeros(m, dtype=dtype, device=device)
    f, g = value_and_grad(x)
    d = _lbfgs_direction(g, S, Y, rho)
    t = torch.ones((), dtype=dtype, device=device)
    nit = torch.zeros((), dtype=torch.int64, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    nfev = 1

    def step(x, f, g, d, t, S, Y, rho, nit, done):
        xt = x + t * d
        if lb is not None:
            xt = torch.minimum(torch.maximum(xt, lb), ub)
        ft, gt = value_and_grad(xt)
        s = xt - x
        gs = torch.dot(g, s)
        ok = (~done) & torch.isfinite(ft) & torch.all(torch.isfinite(gt)) & (gs < 0) & (
            ft <= f + _ARMIJO_C1 * gs)
        y = gt - g
        sy = torch.dot(s, y)
        push = ok & (sy > _CURVATURE * torch.linalg.vector_norm(s)
                     * torch.linalg.vector_norm(y))
        S = torch.where(push, torch.cat([S[1:], s[None]]), S)
        Y = torch.where(push, torch.cat([Y[1:], y[None]]), Y)
        rho = torch.where(push, torch.cat([rho[1:], (1.0 / torch.where(push, sy, 1.0))[None]]),
                          rho)
        x = torch.where(ok, xt, x)
        f = torch.where(ok, ft, f)
        g = torch.where(ok, gt, g)
        nit = nit + ok.to(nit.dtype)
        d = torch.where(ok, _lbfgs_direction(g, S, Y, rho), d)
        t = torch.where(ok, torch.ones_like(t), _BACKTRACK * t)
        stall = t * torch.linalg.vector_norm(d) <= _STALL * (1.0 + torch.linalg.vector_norm(x))
        done = done | (torch.linalg.vector_norm(g) < gtol) | stall | (nit >= maxiter)
        return x, f, g, d, t, S, Y, rho, nit, done

    state = (x, f, g, d, t, S, Y, rho, nit, done)
    prev_value = None
    n_iter = 0
    while True:
        for _ in range(chunk):
            state = step(*state)
        nfev += chunk
        x, f, g, _d, _t, _S, _Y, _rho, nit, done = state
        # the chunk's one read-back
        n_iter, err, value, ended = torch.stack([
            nit.to(dtype), torch.linalg.vector_norm(g), f, done.to(dtype)]).cpu().tolist()
        n_iter = int(n_iter)
        if ended or not np.isfinite(err) or not np.isfinite(value) or err < gtol:
            break
        # SciPy-style relative-improvement stop across chunk boundaries
        if prev_value is not None and (prev_value - value) <= ftol * chunk * max(
                abs(value), abs(prev_value), 1.0):
            break
        prev_value = value

    x = x.cpu().numpy().astype(float)
    with torch.no_grad():
        J0 = float(fun(torch.as_tensor(p0, dtype=dtype, device=device)))
        Jx = float(fun(torch.as_tensor(x, dtype=dtype, device=device)))
    nfev += 2
    best_value_returned = True
    if not np.isfinite(Jx) or Jx > J0:
        x, Jx, best_value_returned = p0.copy(), J0, False

    r = OptimizeResult(
        x=x, fun=Jx, nit=int(n_iter), nfev=nfev, success=bool(np.isfinite(Jx)),
        message="lbfgs-device",
    )
    r.best_value_returned = best_value_returned
    r.history_params = [p0.copy(), x]
    r.history_criterion = [J0, Jx]
    r.initial_params = p0.copy()
    r.final_params = x
    r.bounds = bounds
    r.selection_criterion = criterion
    r.total_time = time.time() - (tic if tic is not None else time.time())
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

    Mesh mode: pass a mesh of ``parallel.make_mesh`` (one card, or a
    process group's ranks) and the model is wrapped in ``parallel.ShardedModelView`` (panel size
    ``shard_block``, default auto_shard_block), so a criterion built on the
    model's likelihood methods runs on the mesh's resident branch or the
    streamed large-n engine.  When ``covparam0`` is None, the init
    heuristic runs on a deterministic subsample of ``init_subsample`` points
    (the dense heuristic would build the full gram)."""
    _check_mesh(mesh)
    if method_options is None:
        method_options = {}

    tic = time.time()
    check_xi_zi_or_loader(xi, zi, dataloader)

    base_model = model
    if mesh is not None:
        if dataloader is not None:
            raise ValueError("mesh mode takes arrays, not a dataloader")
        from gpmp_tpu_torch.parallel.view import ShardedModelView

        model = ShardedModelView(base_model, mesh, block=shard_block)
        if covparam0 is None:
            covparam0 = _subsampled_initial_guess(base_model, xi, zi, init_subsample)

    if covparam0 is None:
        covparam0 = anisotropic_parameters_initial_guess(model, xi, zi, dataloader)

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
            dataloader,
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

    Large-n mode: pass a mesh of ``parallel.make_mesh`` and the criterion
    becomes
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


# ---------------------------- REMAP (default prior) ----------------------------
def select_parameters_with_remap(
    model, xi=None, zi=None, dataloader=None, covparam0=None,
    covparam0_init=None, info=False, verbosity=0, **kwargs,
):
    """Alias of select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior."""
    return select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        covparam0_init=covparam0_init,
        info=info,
        verbosity=verbosity,
        **kwargs,
    )


def update_parameters_with_remap(
    model, xi=None, zi=None, dataloader=None, info=False, verbosity=0, **kwargs
):
    """Alias of update_parameters_with_remap_gaussian_logsigma2_and_logrho_prior."""
    return update_parameters_with_remap_gaussian_logsigma2_and_logrho_prior(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        info=info,
        verbosity=verbosity,
        **kwargs,
    )


# --------------------- REMAP with power laws prior  ----------------------
def select_parameters_with_remap_with_power_laws_prior(
    model, xi=None, zi=None, dataloader=None, covparam0=None, info=False,
    verbosity=0, *,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
):
    return select_parameters_with_criterion(
        model,
        neg_log_restricted_posterior_power_laws_prior,
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
    )


def update_parameters_with_remap_with_power_laws_prior(
    model, xi=None, zi=None, dataloader=None, info=False, *,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
):
    return update_parameters_with_criterion(
        model,
        neg_log_restricted_posterior_power_laws_prior,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        info=info,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
    )


# --------------------- REMAP with gaussian prior on logsigma2  --------------------
def select_parameters_with_remap_gaussian_logsigma2(
    model, xi=None, zi=None, dataloader=None, covparam0=None, info=False,
    verbosity=0, *,
    covparam0_prior=None, prior_gamma=None, prior_sigma2_coverage=None,
    covparam0_init=None,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
):
    """REMAP with Gaussian prior on log(sigma2) anchored at covparam0_prior[0]."""
    covparam0_prior, covparam0_init = resolve_covparam0_prior_and_init(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        covparam0_prior=covparam0_prior,
        covparam0_init=covparam0_init,
    )
    prior_gamma, prior_sigma2_coverage, _, _ = resolve_prior_defaults_for_selection(
        xi=xi,
        dataloader=dataloader,
        gamma=prior_gamma,
        sigma2_coverage=prior_sigma2_coverage,
    )
    prior_log_sigma2_0 = gnp._tensor(covparam0_prior)[0]

    criterion = functools.partial(
        neg_log_restricted_posterior_logsigma2_prior,
        log_sigma2_0=prior_log_sigma2_0,
        gamma=prior_gamma,
        sigma2_coverage=prior_sigma2_coverage,
    )

    return select_parameters_with_criterion(
        model,
        criterion,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0_init,
        info=info,
        verbosity=verbosity,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
    )


def update_parameters_with_remap_gaussian_logsigma2(
    model, xi=None, zi=None, dataloader=None, info=False, verbosity=0, *,
    covparam0=None, covparam0_prior=None, covparam0_init=None,
    prior_gamma=None, prior_sigma2_coverage=None,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
):
    covparam0_prior, covparam0_init = resolve_covparam0_roles_for_update(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        covparam0_prior=covparam0_prior,
        covparam0_init=covparam0_init,
    )
    return select_parameters_with_remap_gaussian_logsigma2(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        covparam0_prior=covparam0_prior,
        covparam0_init=covparam0_init,
        info=info,
        verbosity=verbosity,
        prior_gamma=prior_gamma,
        prior_sigma2_coverage=prior_sigma2_coverage,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
    )


# ------------------ REMAP with priors on logsigma2 and logrho  -------------------
def select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior(
    model, xi=None, zi=None, dataloader=None, covparam0=None, info=False,
    verbosity=0, *,
    covparam0_prior=None, prior_gamma=None, prior_sigma2_coverage=None,
    prior_rho_min_range_factor=None, prior_logrho_min=None,
    prior_log_sigma2_0=None, prior_logrho_0=None, prior_alpha=None,
    covparam0_init=None,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
    mesh=None, shard_block=None, init_subsample=2048,
):
    """Default REMAP: REML + Gaussian log-sigma2 prior + barrier/linear
    logrho prior.

    Mesh mode (``mesh=`` a mesh of ``parallel.make_mesh``): the model is
    wrapped in ShardedModelView so the REML term runs on the mesh; the
    prior-anchor heuristics run on a deterministic subsample of
    ``init_subsample`` points (they would otherwise build the full gram),
    while logrho_min keeps the full xi (O(n log n)).  The support of the
    logrho prior (logrho_0 > logrho_min) is checked once, here, on the
    host."""
    _check_mesh(mesh)
    if mesh is not None and dataloader is not None:
        raise ValueError("mesh mode takes arrays, not a dataloader")
    if mesh is not None and covparam0 is None and covparam0_prior is None:
        covparam0 = _subsampled_initial_guess(model, xi, zi, init_subsample)
    covparam0_prior, covparam0_init = resolve_covparam0_prior_and_init(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        covparam0_prior=covparam0_prior,
        covparam0_init=covparam0_init,
    )
    (
        prior_gamma,
        prior_sigma2_coverage,
        prior_alpha,
        prior_rho_min_range_factor,
        prior_log_sigma2_0,
        prior_logrho_0,
        prior_logrho_min,
    ) = resolve_logsigma2_logrho_prior_args(
        covparam0_prior=covparam0_prior,
        xi=xi,
        dataloader=dataloader,
        prior_gamma=prior_gamma,
        prior_sigma2_coverage=prior_sigma2_coverage,
        prior_alpha=prior_alpha,
        prior_rho_min_range_factor=prior_rho_min_range_factor,
        prior_log_sigma2_0=prior_log_sigma2_0,
        prior_logrho_0=prior_logrho_0,
        prior_logrho_min=prior_logrho_min,
    )
    _check_logrho_support(prior_logrho_min, prior_logrho_0)

    criterion = functools.partial(
        neg_log_restricted_posterior_logsigma2_and_logrho_prior,
        log_sigma2_0=prior_log_sigma2_0,
        gamma=prior_gamma,
        sigma2_coverage=prior_sigma2_coverage,
        logrho_min=prior_logrho_min,
        logrho_0=prior_logrho_0,
        alpha=prior_alpha,
    )

    return select_parameters_with_criterion(
        model,
        criterion,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0_init,
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


def update_parameters_with_remap_gaussian_logsigma2_and_logrho_prior(
    model, xi=None, zi=None, dataloader=None, info=False, verbosity=0, *,
    covparam0=None, covparam0_prior=None, covparam0_init=None,
    prior_gamma=None, prior_sigma2_coverage=None,
    prior_rho_min_range_factor=None, prior_logrho_min=None,
    prior_log_sigma2_0=None, prior_logrho_0=None, prior_alpha=None,
    bounds=None, bounds_auto=True, bounds_delta=10.0,
    method="SLSQP", method_options=None,
    mesh=None, shard_block=None,
):
    covparam0_prior, covparam0_init = resolve_covparam0_roles_for_update(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        covparam0_prior=covparam0_prior,
        covparam0_init=covparam0_init,
    )
    return select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior(
        model,
        xi=xi,
        zi=zi,
        dataloader=dataloader,
        covparam0=covparam0,
        covparam0_prior=covparam0_prior,
        covparam0_init=covparam0_init,
        info=info,
        verbosity=verbosity,
        prior_gamma=prior_gamma,
        prior_sigma2_coverage=prior_sigma2_coverage,
        prior_rho_min_range_factor=prior_rho_min_range_factor,
        prior_logrho_min=prior_logrho_min,
        prior_log_sigma2_0=prior_log_sigma2_0,
        prior_logrho_0=prior_logrho_0,
        prior_alpha=prior_alpha,
        bounds=bounds,
        bounds_auto=bounds_auto,
        bounds_delta=bounds_delta,
        method=method,
        method_options=method_options,
        mesh=mesh,
        shard_block=shard_block,
    )
