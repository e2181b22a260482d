# gpmp_tpu_torch/mcmc/param_posterior.py
"""Posterior sampling of GP covariance parameters from selection criteria
(counterpart of gpmp_tpu/mcmc/param_posterior.py).

Bridges a selection criterion J(theta) to log_prob(theta) = -J(theta)/T
with optional hard sampling_box truncation, and configures each sampler
(MH Haario target 0.3; NUTS; tempered SMC from T = 1e6 to 1 with the ESS
rule; annealed SVGD).  SMC and SVGD evaluate the criterion over their
whole population at once (mcmc.population: ``torch.func.vmap`` of it, one
CUDA graph a population on the card, K1p/K2p on the gram).  When ``info``
is provided, the criterion is recovered from the
DifferentiableSelectionCriterion wrapper stored by parameter selection (its
``crit``, ``x`` and ``z``), so the samplers call the tensor criterion
directly, on the device of its data, and NUTS differentiates it with
torch.autograd.  NaN values and points outside the
box map to -inf by ``torch.where``.

On the card, such a criterion's log probability and its value+grad each
replay one CUDA graph (``ops.capture.Graph``), captured at the first call
for a parameter shape: at small n an evaluation is a few hundred launches
of tiny kernels, which the host enqueues far slower than the card runs
them.  A replay runs the same kernels on the same inputs; the launch
counters of ``ops`` advance by the captured launches at each replay.  A
criterion that reads the card back during an evaluation (the mixed
Cholesky engine's convergence tests) is not captured: it runs as written.
"""

import math

import numpy as np
import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.config import get_chol_engine
from gpmp_tpu_torch.misc.designs import randunif
from gpmp_tpu_torch.ops import capture
from gpmp_tpu_torch.ops.autograd import functorch_active

from . import population
from .mh import MHOptions, MetropolisHastings
from .nuts import NUTSOptions, nuts_sample, plot_nuts_diagnostics
from .smc import run_smc_sampling
from .svgd import SVGDOptions, svgd_sample


GRAPH_REPLAYS = 0  # replays of the log-probability graphs (value and value+grad)


# ---------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------
class _WrappedCriterion:
    """theta -> J(theta) of a DifferentiableSelectionCriterion's tensor
    criterion on its data: a function of theta alone, which a CUDA graph
    can capture (alone, or under torch.func.vmap: mcmc.population)."""

    capturable = True

    def __init__(self, fn, x, z):
        self.fn, self.x, self.z = fn, x, z

    def __call__(self, p):
        return gnp.asarray(self.fn(p, self.x, self.z)).reshape(())


def _traceable_from_wrapper(crit_callable):
    """A theta -> J(theta) function on tensors.

    Criterion callables stored in info are bound methods of
    gnp.DifferentiableSelectionCriterion (host-boundary wrappers whose
    values are floats); the underlying tensor function and data are on the
    wrapper (``crit``, ``x``, ``z``).  Any other callable is called as it
    is and its value made a 0-d tensor.
    """
    wrapper = getattr(crit_callable, "__self__", None)
    if wrapper is not None and hasattr(wrapper, "crit") and hasattr(wrapper, "x"):
        return _WrappedCriterion(wrapper.crit, wrapper.x, wrapper.z)
    return lambda p: gnp.asarray(crit_callable(p)).reshape(())


def _resolve_selection_criterion(info, selection_criterion, *,
                                 require_differentiable):
    if (info is None) == (selection_criterion is None):
        raise ValueError("Provide exactly one of: info or selection_criterion.")
    if selection_criterion is not None:
        return _traceable_from_wrapper(selection_criterion)

    def _get(obj, name):
        if isinstance(obj, dict):
            return obj.get(name)
        return getattr(obj, name, None)

    if require_differentiable:
        crit = _get(info, "selection_criterion")
    else:
        crit = _get(info, "selection_criterion_nograd") or _get(
            info, "selection_criterion"
        )
    if crit is None or not callable(crit):
        raise ValueError(
            "info must provide selection_criterion or "
            "selection_criterion_nograd."
        )
    return _traceable_from_wrapper(crit)


def _info_covparam(info):
    if isinstance(info, dict):
        return info.get("covparam")
    return getattr(info, "covparam", None)


def _host(a):
    return np.asarray(gnp.to_np(a), dtype=float)


def _infer_dim(info, param_initial_states, box):
    if param_initial_states is not None:
        theta = _host(param_initial_states)
        if theta.ndim == 0:
            return 1
        if theta.ndim == 1:
            return int(theta.shape[0])
        if theta.ndim == 2:
            return int(theta.shape[1])
        raise ValueError("param_initial_states must be scalar, 1D or 2D.")
    if info is not None:
        x0 = _host(_info_covparam(info))
        if x0.ndim != 1:
            raise ValueError("info.covparam must be 1D.")
        return int(x0.shape[0])
    if box is not None:
        lower, _ = box
        if np.isscalar(lower):
            raise ValueError(
                "Cannot infer dim from scalar box. Provide "
                "param_initial_states or info.covparam."
            )
        return int(len(lower))
    raise ValueError(
        "Cannot infer dim. Provide param_initial_states or info.covparam, "
        "or a non-scalar box."
    )


def _normalize_bounds(box, dim, box_name="box"):
    """(lower, upper) as tensors on the configured device and as host
    arrays."""
    if not (isinstance(box, (list, tuple)) and len(box) == 2):
        raise ValueError(f"{box_name} must be of the form [lower, upper].")
    lower, upper = box
    if np.isscalar(lower) and np.isscalar(upper):
        lower_np = np.full(dim, float(lower))
        upper_np = np.full(dim, float(upper))
    else:
        lower_np = _host(lower).reshape(-1)
        upper_np = _host(upper).reshape(-1)
        if lower_np.shape[0] == 1:
            lower_np = np.tile(lower_np, dim)
        if upper_np.shape[0] == 1:
            upper_np = np.tile(upper_np, dim)
        if lower_np.shape[0] != dim or upper_np.shape[0] != dim:
            raise ValueError(f"{box_name} bounds must match dimension.")
    return gnp.asarray(lower_np), gnp.asarray(upper_np), lower_np, upper_np


def _normalize_initial_states(info, param_initial_states, n_chains, dim):
    if param_initial_states is None:
        if info is None:
            raise ValueError(
                "param_initial_states must be provided when info is None and "
                "random_init is False."
            )
        x0 = _host(_info_covparam(info)).reshape(-1)
        if x0.shape[0] != dim:
            raise ValueError("info.covparam has incompatible dimension.")
        return gnp.asarray(np.tile(x0, (n_chains, 1)))

    theta = _host(param_initial_states)
    if theta.ndim == 0:
        if dim != 1:
            raise ValueError(
                "Scalar param_initial_states is only valid when dim == 1."
            )
        theta = np.tile(theta.reshape(1, 1), (n_chains, 1))
    elif theta.ndim == 1:
        n0 = theta.shape[0]
        if n0 == dim:
            theta = np.tile(theta.reshape(1, -1), (n_chains, 1))
        elif dim == 1 and n0 == n_chains:
            theta = theta.reshape(n_chains, 1)
        else:
            raise ValueError(
                f"1D param_initial_states must have length {dim}"
                + (f" (or {n_chains} when dim == 1)." if dim == 1 else ".")
            )
    elif theta.ndim == 2:
        r, c = theta.shape
        if r == n_chains and c == dim:
            pass
        elif r == 1 and c == dim:
            theta = np.tile(theta, (n_chains, 1))
        elif r == dim and c == n_chains:
            theta = theta.T
        else:
            raise ValueError(
                "2D param_initial_states must have shape "
                f"({n_chains}, {dim}), (1, {dim}), or ({dim}, {n_chains})."
            )
    else:
        raise ValueError("param_initial_states must be scalar, 1D, or 2D.")
    if theta.shape != (n_chains, dim):
        raise ValueError(
            f"param_initial_states must have shape ({n_chains}, {dim})."
        )
    return gnp.asarray(theta)


def _random_initial_states(lower_np, upper_np, dim, n_chains, seed=None):
    return gnp.asarray(randunif(dim, n_chains, [lower_np, upper_np], seed=seed))


class _LogProb:
    """log_prob(theta) = -J(theta)/T, -inf outside the box or on NaN, by
    ``torch.where`` (so no host read, and autograd passes through).

    ``potential_and_grad(q)`` gives (U, grad U), U = -log_prob, for NUTS.
    With a criterion of parameter selection (``_WrappedCriterion``) on the
    card, both replay a CUDA graph (``ops.capture.Graph``, one per kind,
    parameter shape, dtype, device and Cholesky engine) unless autograd is
    asked to go through the call.  A criterion that reads the card back
    (the mixed engine, at n >= 192) is not captured and runs as written, as
    it does on the CPU and for any other criterion."""

    def __init__(self, criterion_fn, lower_b, upper_b, temperature):
        self.criterion_fn, self.lower_b, self.upper_b = criterion_fn, lower_b, upper_b
        self.temperature = temperature
        self.capturable = isinstance(criterion_fn, _WrappedCriterion)
        self._graphs = {} if self.capturable else None

    def _value(self, p):
        lp = -self.criterion_fn(p) / self.temperature
        lp = torch.where(torch.isnan(lp), -math.inf, lp)
        if self.lower_b is not None:
            outside = torch.any(p < self.lower_b) | torch.any(p > self.upper_b)
            lp = torch.where(outside, -math.inf, lp)
        return lp

    uncaptured = _value  # the function as written (mcmc.population's route probe)

    def _potential_and_grad(self, q):
        with torch.enable_grad():
            U = -self._value(q)
            (g,) = torch.autograd.grad(U, q)
        return U.detach(), g

    def _graph(self, kind, q):
        """The graph's outputs, or None where the criterion is not captured."""
        global GRAPH_REPLAYS
        key = (kind, tuple(q.shape), q.dtype, q.device, get_chol_engine())
        if key not in self._graphs:
            fn = ((lambda qq: (self._value(qq),)) if kind == "value"
                  else self._potential_and_grad)
            try:
                self._graphs[key] = capture.Graph(fn, (q,), grad=kind != "value",
                                                  no_host_reads=True)
            except capture.ReadsBack:
                self._graphs[key] = None
        graph = self._graphs[key]
        if graph is None:
            return None
        GRAPH_REPLAYS += 1
        return graph(q)

    def __call__(self, p):
        p = gnp.asarray(p)
        if (self._graphs is not None and p.is_cuda and not functorch_active()
                and not (torch.is_grad_enabled() and p.requires_grad)):
            out = self._graph("value", p)
            if out is not None:
                return out[0]
        return self._value(p)

    def potential_and_grad(self, q):
        q = gnp.asarray(q)
        if self._graphs is not None and q.is_cuda:
            out = self._graph("value+grad", q)
            if out is not None:
                return out
        return self._potential_and_grad(q.detach().requires_grad_(True))


def _make_log_prob(criterion_fn, lower_b, upper_b, temperature=1.0):
    """log_prob(theta) = -J(theta)/T, -inf outside the box or on NaN
    (``_LogProb``)."""
    temperature = float(temperature)
    if temperature <= 0.0:
        raise ValueError("temperature must be > 0.")
    return _LogProb(criterion_fn, lower_b, upper_b, temperature)


def get_log_target_values(mh, *, discard_burnin=False):
    """Stored MH log-target traces, optionally post-burn-in."""
    vals = getattr(mh, "log_target_values", None)
    if vals is None:
        raise ValueError(
            "mh.log_target_values is not available. Run mh.scheduler(...) "
            "first."
        )
    vals = np.asarray(vals)
    if vals.ndim != 2:
        raise ValueError("mh.log_target_values must be a 2D array.")
    if not discard_burnin:
        return gnp.asarray(vals)
    b = int(mh.burnin_period)
    if b < 0:
        raise ValueError("mh.burnin_period must be >= 0.")
    if b > vals.shape[1]:
        raise ValueError(
            "mh.burnin_period cannot exceed the number of stored steps."
        )
    return gnp.asarray(vals[:, b:])


def _initial_states(info, param_initial_states, random_init, init_box, sampling_box,
                    n_chains, seed):
    """(dim, theta0, lower_b, upper_b) as both samplers resolve them."""
    dim_box = init_box if init_box is not None else sampling_box
    dim = _infer_dim(info, param_initial_states, dim_box)

    lower_init_np = upper_init_np = None
    if init_box is not None:
        _, _, lower_init_np, upper_init_np = _normalize_bounds(
            init_box, dim, box_name="init_box"
        )
    lower_b = upper_b = None
    if sampling_box is not None:
        lower_b, upper_b, _, _ = _normalize_bounds(sampling_box, dim,
                                                   box_name="sampling_box")
    if random_init:
        if init_box is None:
            raise ValueError("init_box must be provided when random_init is True.")
        theta0 = _random_initial_states(lower_init_np, upper_init_np, dim,
                                        n_chains, seed=seed)
    else:
        theta0 = _normalize_initial_states(info, param_initial_states,
                                           n_chains, dim)
    return dim, theta0, lower_b, upper_b


# ---------------------------------------------------------------------
# Metropolis-Hastings
# ---------------------------------------------------------------------
def sample_from_selection_criterion_mh(
    info=None, selection_criterion=None, param_initial_states=None,
    random_init=False, init_box=None, sampling_box=None, temperature=1.0,
    n_steps_total=10_000, burnin_period=4_000, n_chains=2, n_pool=2,
    silent=False, show_progress=True, plot_chains=True,
    plot_empirical_distributions=True, seed=None, blocks_per_dispatch=1,
):
    """Adaptive MH on log_target = -J/T (Haario, target acceptance 0.3,
    adapt interval 50).  Returns (samples_post_burnin, mh), the samples a
    tensor on the configured device.

    blocks_per_dispatch: MHOptions.blocks_per_dispatch (where the early-stop
    checks and checkpoints fall; the draws do not depend on it)."""
    crit = _resolve_selection_criterion(info, selection_criterion,
                                        require_differentiable=False)
    dim, theta0, lower_b, upper_b = _initial_states(
        info, param_initial_states, random_init, init_box, sampling_box, n_chains, seed)
    if n_steps_total < burnin_period:
        raise ValueError("n_steps_total must be greater than burnin_period.")

    log_target = _make_log_prob(crit, lower_b, upper_b, temperature=temperature)

    show_prog = show_progress and not silent
    options = MHOptions(
        dim=dim,
        n_chains=n_chains,
        target_acceptance=0.3,
        proposal_distribution_param_init=0.1 * np.ones(dim),
        adaptation_method="Haario",
        adaptation_interval=50,
        haario_adapt_factor_burnin_phase=1.0,
        haario_adapt_factor_sampling_phase=0.5,
        freeze_adaptation=False,
        discard_burnin=False,
        n_pool=n_pool,
        blocks_per_dispatch=blocks_per_dispatch,
        show_global_progress=show_prog,
        init_msg=(
            None if silent
            else "Sampling from posterior distribution of GP parameters..."
        ),
        seed=seed,
    )

    mh = MetropolisHastings(log_target=log_target, options=options)
    param_samples = mh.scheduler(
        chains_state_initial=theta0, n_steps_total=n_steps_total,
        burnin_period=burnin_period,
    )

    if not silent:
        print("\n")
        mh.check_acceptance_rates(burnin_period=mh.burnin_period)
        if n_chains >= 2:
            mh.check_convergence_gelman_rubin(burnin_period=mh.burnin_period)

    if plot_chains:
        mh.plot_chains()
    if plot_empirical_distributions:
        mh.plot_empirical_distributions()

    return param_samples[:, mh.burnin_period:, :], mh


# ---------------------------------------------------------------------
# NUTS
# ---------------------------------------------------------------------
def sample_from_selection_criterion_nuts(
    info=None, selection_criterion=None, param_initial_states=None,
    random_init=False, init_box=None, sampling_box=None, num_samples=2_000,
    num_warmup=1_000, n_chains=2, target_accept=0.8, max_depth=10,
    delta_max=1_000.0, jitter=1e-4, init_step_size=None, init_mass_diag=None,
    seed=None, progress=True, verbose=1, log_every=50,
    options: NUTSOptions = None, plot_diagnostics=False,
    diagnostics_window=50, diagnostics_show=True, diagnostics_save_dir=None,
):
    """NUTS on log_prob = -J(theta); returns (samples (n_chains,
    num_samples, dim), info_nuts), the samples a tensor on the configured
    device."""
    crit = _resolve_selection_criterion(info, selection_criterion,
                                        require_differentiable=True)
    _dim, theta0, lower_b, upper_b = _initial_states(
        info, param_initial_states, random_init, init_box, sampling_box, n_chains, seed)

    log_prob = _make_log_prob(crit, lower_b, upper_b)

    samples_raw, info_nuts = nuts_sample(
        log_prob=log_prob, q_init=theta0,
        num_samples=num_samples, num_warmup=num_warmup,
        target_accept=target_accept, max_depth=max_depth, delta_max=delta_max,
        jitter=jitter, init_step_size=init_step_size,
        init_mass_diag=init_mass_diag, seed=seed, progress=progress,
        verbose=verbose, log_every=log_every, options=options,
    )

    if plot_diagnostics:
        plot_nuts_diagnostics(samples_raw, info_nuts,
                              ma_window=diagnostics_window)

    return samples_raw.transpose(0, 1), info_nuts


# ---------------------------------------------------------------------
# SMC
# ---------------------------------------------------------------------
def _tempered_population(crit, lower_b, upper_b):
    """(x (B, d) or (d,), T) -> -J(x_b)/T, -inf on NaN and outside the box:
    the SMC log target over the particle population (its criterion, a
    ``population.Criterion``, is the function's ``criterion``)."""
    vcrit = population.Criterion(crit)

    def logpdf_temp(x, temperature):
        x = gnp.asarray(x)
        squeeze = x.ndim == 1
        if squeeze:
            x = x.reshape(1, -1)
        out = -vcrit(x) / temperature
        out = torch.where(torch.isnan(out), -math.inf, out)
        if lower_b is not None:
            in_box = torch.all(x >= lower_b, dim=1) & torch.all(x <= upper_b, dim=1)
            out = torch.where(in_box, out, -math.inf)
        return out[0] if squeeze else out

    logpdf_temp.criterion = vcrit
    return logpdf_temp


def sample_from_selection_criterion_smc(
    info=None, selection_criterion=None, init_box=None, sampling_box=None,
    n_particles=1000, initial_temperature=1e6, final_temperature=1.0,
    min_ess_ratio=0.5, mh_steps=20, max_stages=50, debug=False,
    plot_marginals=False, plot_particles=False, seed=None,
):
    """Tempered SMC targeting exp(-J/T) from initial_temperature down to
    final_temperature with the ESS ladder rule.  Returns (particles,
    smc_instance), the particles a tensor on the configured device.

    The criterion runs over the whole particle population at once
    (``mcmc.population.Criterion``); the route it took is
    ``smc_instance.population_route``.  ``max_stages`` is accepted and
    unused, as in the JAX package."""
    crit = _resolve_selection_criterion(info, selection_criterion,
                                        require_differentiable=False)
    if init_box is None:
        raise ValueError("init_box must be provided for SMC.")
    dim = _infer_dim(info, None, init_box)
    _normalize_bounds(init_box, dim, box_name="init_box")

    lower_b = upper_b = None
    if sampling_box is not None:
        lower_b, upper_b, _, _ = _normalize_bounds(sampling_box, dim,
                                                   box_name="sampling_box")

    logpdf_temp = _tempered_population(crit, lower_b, upper_b)

    rng = np.random.default_rng(seed) if seed is not None else None
    particles, smc_instance = run_smc_sampling(
        logpdf_parameterized_function=logpdf_temp,
        initial_logpdf_param=initial_temperature,
        target_logpdf_param=final_temperature,
        compute_next_logpdf_param_method="ess",
        min_ess_ratio=min_ess_ratio,
        init_box=init_box,
        n_particles=n_particles,
        mh_steps=mh_steps,
        debug=debug,
        plot_empirical_distributions=plot_marginals,
        rng=rng,
    )
    smc_instance.population_route = logpdf_temp.criterion.route
    return particles, smc_instance


# ---------------------------------------------------------------------
# SVGD
# ---------------------------------------------------------------------
def _jittered(particles0, n_particles, init_jitter, rng):
    if int(n_particles) > 1 and float(init_jitter) > 0.0:
        particles0 = particles0 + float(init_jitter) * rng.normal(size=particles0.shape)
    return particles0


def sample_from_selection_criterion_svgd(
    info=None, selection_criterion=None, particles_initial=None,
    random_init=False, init_box=None, sampling_box=None, n_particles=32,
    n_steps=500, step_size=1e-2, initial_temperature=10.0,
    final_temperature=1.0, annealing_schedule="geometric", bandwidth=None,
    bandwidth_scale=1.0, bandwidth_min=None, preconditioner_diag=None,
    init_jitter=1e-3, jitter=1e-12, progress=True, verbose=1, log_every=50,
    store_particles_history=False, options: SVGDOptions = None, seed=None,
):
    """Annealed SVGD on exp(-J/T); returns (particles, info_svgd), the
    particles a tensor on the configured device.  The initial particles
    come from the NumPy generator seeded by ``seed`` as in the JAX package,
    so both packages start from the same particles."""
    crit = _resolve_selection_criterion(info, selection_criterion,
                                        require_differentiable=True)
    dim_box = init_box if init_box is not None else sampling_box
    dim = _infer_dim(info, particles_initial, dim_box)

    lower_b = upper_b = lower_np = upper_np = None
    if sampling_box is not None:
        lower_b, upper_b, lower_np, upper_np = _normalize_bounds(
            sampling_box, dim, box_name="sampling_box")

    rng = np.random.default_rng(seed)

    init_box_eff = None
    if particles_initial is None:
        if random_init:
            if init_box is None:
                raise ValueError(
                    "init_box must be provided when random_init is True."
                )
            particles0 = None
            init_box_eff = init_box
        else:
            if info is None:
                raise ValueError(
                    "particles_initial must be provided when info is None and "
                    "random_init is False."
                )
            x0 = _host(_info_covparam(info)).reshape(-1)
            if x0.shape[0] != dim:
                raise ValueError("info.covparam has incompatible dimension.")
            particles0 = _jittered(np.tile(x0.reshape(1, -1), (int(n_particles), 1)),
                                   n_particles, init_jitter, rng)
    else:
        particles0 = _host(particles_initial)
        if particles0.ndim == 0:
            if dim != 1:
                raise ValueError(
                    "Scalar particles_initial is only valid when dim == 1."
                )
            particles0 = _jittered(np.tile(particles0.reshape(1, 1), (int(n_particles), 1)),
                                   n_particles, init_jitter, rng)
        elif particles0.ndim == 1:
            if particles0.shape[0] != dim:
                raise ValueError(
                    "1D particles_initial must have length equal to dim."
                )
            particles0 = _jittered(np.tile(particles0.reshape(1, -1), (int(n_particles), 1)),
                                   n_particles, init_jitter, rng)
        elif particles0.ndim == 2:
            if particles0.shape[1] != dim:
                raise ValueError(
                    "2D particles_initial must have shape (n_particles, dim)."
                )
            if particles0.shape[0] == 1 and int(n_particles) > 1:
                particles0 = _jittered(np.tile(particles0, (int(n_particles), 1)),
                                       n_particles, init_jitter, rng)
        else:
            raise ValueError("particles_initial must be scalar, 1D, or 2D.")

    if particles0 is not None and lower_b is not None:
        particles0 = np.clip(particles0, lower_np.reshape(1, -1), upper_np.reshape(1, -1))
    n_particles_eff = (
        int(particles0.shape[0]) if particles0 is not None else int(n_particles)
    )

    log_prob = _make_log_prob(crit, lower_b, upper_b, temperature=1.0)

    if options is None:
        options = SVGDOptions(
            n_steps=n_steps, step_size=step_size, bandwidth=bandwidth,
            bandwidth_scale=bandwidth_scale, bandwidth_min=bandwidth_min,
            preconditioner_diag=preconditioner_diag,
            initial_temperature=initial_temperature,
            final_temperature=final_temperature,
            annealing_schedule=annealing_schedule, sampling_box=sampling_box,
            store_particles_history=store_particles_history, verbose=verbose,
            progress=progress, log_every=log_every, jitter=jitter, seed=seed,
        )

    return svgd_sample(
        log_prob,
        particles_initial=(
            gnp.asarray(particles0) if particles0 is not None else None
        ),
        n_particles=n_particles_eff, dim=dim, init_box=init_box_eff,
        options=options,
    )
