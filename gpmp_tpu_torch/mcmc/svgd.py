# gpmp_tpu_torch/mcmc/svgd.py
"""Annealed Stein variational gradient descent, counterpart of
gpmp_tpu/mcmc/svgd.py.

RBF kernel with median-heuristic bandwidth / log(n+1), per-particle
tempered scores with dead-particle masking, kernel-weighted transport +
2/h repulsion, diagonal preconditioner, box projection, linear/geometric
temperature schedule.

Design: a step evaluates the tempered log probability and its gradient
over the whole population at once (``torch.func.vmap`` of
``torch.func.grad_and_value``: on the gram K1p forward and K2p backward,
mcmc.population), then the kernel algebra, with no read back to the host.
On the card, the step of a criterion of parameter selection is captured
once as a CUDA graph and replayed per step (mcmc.population.Graphs; the
temperature is a graph input); the traces stay on the device and are read
back once after the run.  A log probability that reads the device back
(the mixed Cholesky engine) runs particle by particle, through autograd.
The median heuristic is the mean of the two middle values of the sorted
n (n - 1) off-diagonal squared distances (``jnp.nanmedian``'s value;
``torch.median`` would take the lower one).
"""

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.misc.designs import randunif
from . import population
from .mh import check_chain_mesh


@dataclass
class SVGDOptions:
    n_steps: int = 500
    step_size: float = 1e-2
    bandwidth: Optional[float] = None
    bandwidth_scale: float = 1.0
    bandwidth_min: Optional[float] = None
    preconditioner_diag: Optional[np.ndarray] = None
    initial_temperature: float = 10.0
    final_temperature: float = 1.0
    annealing_schedule: str = "geometric"
    sampling_box: Optional[list] = None
    store_particles_history: bool = False
    # None or a one-device mesh (parallel.make_mesh): the particles are not
    # sharded over more devices (ROADMAP queue 1, item 10c)
    mesh: Optional[Any] = None
    mesh_axis_name: str = "particles"
    verbose: int = 1
    progress: bool = True
    log_every: int = 50
    jitter: float = 1e-12
    seed: Optional[int] = None


def _normalize_bounds(box, dim, *, box_name="box"):
    if not (isinstance(box, (list, tuple)) and len(box) == 2):
        raise ValueError(f"{box_name} must be of the form [lower, upper].")
    lower, upper = box
    if np.isscalar(lower) and np.isscalar(upper):
        lower_b = np.full(dim, float(lower))
        upper_b = np.full(dim, float(upper))
    else:
        lower_b = np.asarray(gnp.to_np(lower), dtype=float).reshape(-1)
        upper_b = np.asarray(gnp.to_np(upper), dtype=float).reshape(-1)
        if lower_b.shape[0] == 1:
            lower_b = np.tile(lower_b, dim)
        if upper_b.shape[0] == 1:
            upper_b = np.tile(upper_b, dim)
        if lower_b.shape[0] != dim or upper_b.shape[0] != dim:
            raise ValueError(f"{box_name} bounds must match dimension.")
    return gnp.asarray(lower_b), gnp.asarray(upper_b), lower_b, upper_b


def _annealed_temperatures(n_steps, initial_temperature, final_temperature,
                           schedule):
    t0, t1 = float(initial_temperature), float(final_temperature)
    if t0 <= 0.0 or t1 <= 0.0:
        raise ValueError("Temperatures must be > 0.")
    if n_steps <= 1:
        return np.full(max(n_steps, 0), t1)
    u = np.arange(n_steps) / (n_steps - 1)
    if schedule == "linear":
        return t0 + u * (t1 - t0)
    if schedule == "geometric":
        return t0 * (t1 / t0) ** u
    raise ValueError("annealing_schedule must be 'linear' or 'geometric'.")


def _resolve_preconditioner(preconditioner_diag, dim, *, jitter):
    if preconditioner_diag is None:
        return gnp.ones(dim)
    diag = np.asarray(preconditioner_diag, dtype=float).reshape(-1)
    if diag.shape[0] == 1:
        diag = np.tile(diag, dim)
    if diag.shape[0] != dim:
        raise ValueError(
            "preconditioner_diag must have length equal to particle dimension."
        )
    if np.any(diag <= 0.0):
        raise ValueError("preconditioner_diag must be strictly positive.")
    return gnp.asarray(np.clip(diag, float(jitter), None))


def rbf_kernel_matrix(particles, *, bandwidth=None, bandwidth_scale=1.0,
                      bandwidth_min=None, jitter=1e-12):
    """RBF kernel on particles with median-heuristic bandwidth.

    Returns (kernel, sq_dists, h), h a 0-d tensor.  h = scale *
    median(off-diagonal sq_dists) / log(n+1) when bandwidth is None
    (reference svgd.py:169-238), the median the mean of the two middle
    values of the n (n - 1) sorted entries; no read back to the host.
    Tensors are taken on their own device.
    """
    particles = gnp._tensor(particles)
    if particles.ndim != 2:
        raise ValueError("particles must have shape (n_particles, dim).")
    if float(bandwidth_scale) <= 0.0:
        raise ValueError("bandwidth_scale must be > 0.")
    if bandwidth_min is not None and float(bandwidth_min) <= 0.0:
        raise ValueError("bandwidth_min must be > 0 when provided.")

    diffs = particles[:, None, :] - particles[None, :, :]
    sq_dists = torch.sum(diffs * diffs, dim=2)
    n = particles.shape[0]
    dt, dev = particles.dtype, particles.device

    if bandwidth is None:
        if n > 1:
            # the diagonal's n entries sort last: the first n (n - 1) are the
            # off-diagonal ones, an even count
            eye = torch.eye(n, dtype=torch.bool, device=dev)
            s = torch.sort(torch.where(eye, math.inf, sq_dists).reshape(-1)).values
            k = n * (n - 1) // 2
            median_sq = s[k - 1] * 0.5 + s[k] * 0.5
        else:
            median_sq = torch.zeros((), dtype=dt, device=dev)
        scale = max(math.log(float(n) + 1.0), 1e-12)
        h = float(bandwidth_scale) * median_sq / scale
        h = torch.where(torch.isfinite(h) & (h > float(jitter)), h,
                        max(float(bandwidth_scale), float(jitter)))
    else:
        h = torch.full((), float(bandwidth_scale) * float(bandwidth), dtype=dt, device=dev)
        h = torch.where(h > float(jitter), h, float(jitter))
    if bandwidth_min is not None:
        h = torch.clamp_min(h, float(bandwidth_min))

    kernel = torch.exp(-sq_dists / h)
    return kernel, sq_dists, h


def _single_value_and_grad(log_prob, theta, temperature):
    """(log_prob(theta) / T, its gradient) through autograd, one member."""
    with torch.enable_grad():
        t = theta.detach().requires_grad_(True)
        v = gnp._tensor(log_prob(t)).reshape(()) / temperature
        if not v.requires_grad:
            return v.detach(), torch.zeros_like(t)
        (g,) = torch.autograd.grad(v, t, allow_unused=True)
    return v.detach(), torch.zeros_like(t) if g is None else g


def _make_step(log_prob, *, step_size, bandwidth, bandwidth_scale,
               bandwidth_min, preconditioner, lower_b, upper_b, jitter, route):
    """SVGD step: (particles, temperature (0-d tensor)) -> (particles',
    values, h, mean velocity norm, alive count), all tensors."""

    def tempered_vg(theta, temperature):
        def lp(t):
            return gnp._tensor(log_prob(t)).reshape(()) / temperature

        grad, value = torch.func.grad_and_value(lp)(theta)
        return value, grad

    def step(particles, temperature):
        if lower_b is not None:
            particles = torch.clamp(particles, lower_b[None, :], upper_b[None, :])

        if route == "particles":
            vg = [_single_value_and_grad(log_prob, t, temperature) for t in particles]
            values = torch.stack([v for v, _ in vg])
            scores = torch.stack([g for _, g in vg])
        else:
            values, scores = torch.func.vmap(tempered_vg, in_dims=(0, None))(
                particles, temperature)
        if lower_b is not None:
            outside = torch.any(particles < lower_b, dim=1) | torch.any(particles > upper_b, dim=1)
            values = torch.where(outside, -math.inf, values)
        values = torch.where(torch.isnan(values), -math.inf, values)
        scores = torch.where(torch.isfinite(scores), scores, 0.0)
        alive = torch.isfinite(values)
        alive_count = torch.sum(alive)
        scores = torch.where(alive[:, None], scores, 0.0)

        kernel, _sq_dists, h = rbf_kernel_matrix(
            particles, bandwidth=bandwidth, bandwidth_scale=bandwidth_scale,
            bandwidth_min=bandwidth_min, jitter=jitter,
        )
        kernel = kernel * alive[:, None] * alive[None, :]

        denom = torch.clamp_min(alive_count, 1).to(particles.dtype)
        score_term = (kernel @ scores) / denom
        diffs = particles[:, None, :] - particles[None, :, :]
        repulsion = (2.0 / h) * torch.sum(kernel[:, :, None] * diffs, dim=1) / denom
        velocity = (score_term + repulsion) * preconditioner[None, :]
        velocity = torch.where(alive[:, None], velocity, 0.0)
        velocity = torch.where(torch.isfinite(velocity), velocity, 0.0)

        particles_next = particles + float(step_size) * velocity
        if lower_b is not None:
            particles_next = torch.clamp(particles_next, lower_b[None, :], upper_b[None, :])
        velocity_norm = torch.mean(torch.linalg.vector_norm(velocity, dim=1))
        return particles_next, values, h, velocity_norm, alive_count

    return step


def _info(values, h, velocity_norm, alive_count, temperature):
    return {"log_prob_values": values, "bandwidth": h, "velocity_norm": velocity_norm,
            "alive_count": alive_count, "temperature": temperature}


def svgd_step(log_prob, particles, *, step_size, temperature=1.0,
              bandwidth=None, bandwidth_scale=1.0, bandwidth_min=None,
              preconditioner_diag=None, sampling_box=None, jitter=1e-12):
    """One SVGD update (eager); returns (particles', info)."""
    particles = gnp.asarray(particles)
    if particles.ndim != 2:
        raise ValueError("particles must have shape (n_particles, dim).")
    if float(step_size) <= 0.0:
        raise ValueError("step_size must be > 0.")
    if float(temperature) <= 0.0:
        raise ValueError("temperature must be > 0.")
    dim = particles.shape[1]
    lower_b = upper_b = None
    if sampling_box is not None:
        lower_b, upper_b, _, _ = _normalize_bounds(sampling_box, dim,
                                                   box_name="sampling_box")
    preconditioner = _resolve_preconditioner(preconditioner_diag, dim,
                                             jitter=float(jitter))
    route = population.route(log_prob, particles[0])
    step = _make_step(
        log_prob, step_size=step_size, bandwidth=bandwidth,
        bandwidth_scale=bandwidth_scale, bandwidth_min=bandwidth_min,
        preconditioner=preconditioner, lower_b=lower_b, upper_b=upper_b,
        jitter=jitter, route=route,
    )
    T = torch.tensor(float(temperature), dtype=particles.dtype, device=particles.device)
    with torch.no_grad():
        particles_next, *out = step(particles, T)
    return particles_next, _info(*out, T)


def svgd_sample(log_prob, particles_initial=None, *, n_particles=None,
                dim=None, init_box=None, options: SVGDOptions = None):
    """Annealed SVGD run.

    Returns (particles, info) with traces: log_prob_trace (n_steps, n),
    bandwidth/temperature/velocity_norm traces, particles history
    (optional), final log-probs, and ``route`` (mcmc.population's route of
    the log probability: ``"graph"``, ``"vmap"`` or ``"particles"``).
    """
    opts = SVGDOptions() if options is None else options
    if int(opts.n_steps) < 0:
        raise ValueError("n_steps must be >= 0.")
    check_chain_mesh(opts.mesh)

    if particles_initial is None:
        if init_box is None:
            raise ValueError("Provide particles_initial or init_box.")
        if n_particles is None or int(n_particles) <= 0:
            raise ValueError(
                "n_particles must be provided and > 0 when init_box is used."
            )
        if dim is None:
            lower = init_box[0]
            if np.isscalar(lower):
                raise ValueError(
                    "dim must be provided when init_box lower bound is scalar."
                )
            dim = int(len(lower))
        _, _, lower_np, upper_np = _normalize_bounds(init_box, int(dim),
                                                     box_name="init_box")
        particles = gnp.asarray(
            randunif(int(dim), int(n_particles), [lower_np, upper_np],
                     seed=opts.seed)
        )
    else:
        particles = gnp.asarray(particles_initial)
        if particles.ndim == 1:
            particles = particles.reshape(1, -1)
        elif particles.ndim != 2:
            raise ValueError("particles_initial must be 1D or 2D.")

    n_eff, dim_eff = particles.shape
    if n_particles is not None and int(n_particles) != n_eff:
        raise ValueError("n_particles does not match particles_initial.")
    if dim is not None and int(dim) != dim_eff:
        raise ValueError("dim does not match particles_initial.")

    lower_b = upper_b = None
    if opts.sampling_box is not None:
        lower_b, upper_b, _, _ = _normalize_bounds(opts.sampling_box, dim_eff,
                                                   box_name="sampling_box")
    preconditioner = _resolve_preconditioner(opts.preconditioner_diag, dim_eff,
                                             jitter=float(opts.jitter))
    route = population.route(log_prob, particles[0])
    step = _make_step(
        log_prob, step_size=opts.step_size, bandwidth=opts.bandwidth,
        bandwidth_scale=opts.bandwidth_scale, bandwidth_min=opts.bandwidth_min,
        preconditioner=preconditioner, lower_b=lower_b, upper_b=upper_b,
        jitter=opts.jitter, route=route,
    )
    if route == "graph":
        step = population.Graphs(step)

    n_steps = int(opts.n_steps)
    temperatures = gnp.asarray(
        _annealed_temperatures(n_steps, opts.initial_temperature,
                               opts.final_temperature, opts.annealing_schedule)
    ).to(particles.dtype)
    store_history = bool(opts.store_particles_history)
    trace = {k: [] for k in ("log_prob_values", "bandwidth", "velocity_norm", "alive_count")}
    history = []
    with torch.no_grad():
        for s in range(n_steps):
            particles, *out = step(particles, temperatures[s])
            for k, v in zip(trace, out):
                trace[k].append(v)
            if store_history:
                history.append(particles)
    dev = particles.device
    traces = {
        "log_prob_values": (torch.stack(trace["log_prob_values"]) if n_steps
                            else torch.zeros((0, n_eff), dtype=particles.dtype, device=dev)),
        "bandwidth": (torch.stack(trace["bandwidth"]) if n_steps
                      else torch.zeros((0,), dtype=particles.dtype, device=dev)),
        "temperature": temperatures,
        "velocity_norm": (torch.stack(trace["velocity_norm"]) if n_steps
                          else torch.zeros((0,), dtype=particles.dtype, device=dev)),
        "alive_count": (torch.stack(trace["alive_count"]) if n_steps
                        else torch.zeros((0,), dtype=torch.int64, device=dev)),
    }

    # host-side progress log from traces (message format of the reference)
    if opts.progress and int(opts.verbose) > 0 and n_steps > 0:
        lp_trace = gnp.to_np(traces["log_prob_values"])
        vel_trace = gnp.to_np(traces["velocity_norm"])
        bw_trace = gnp.to_np(traces["bandwidth"])
        T_trace = gnp.to_np(traces["temperature"])
        alive_trace = gnp.to_np(traces["alive_count"])
        for s in range(n_steps):
            if not (
                s == 0
                or s + 1 == n_steps
                or (s + 1) % max(int(opts.log_every), 1) == 0
            ):
                continue
            alive = np.isfinite(lp_trace[s])
            n_alive = int(alive_trace[s])
            if n_alive > 0:
                mean_lp = float(lp_trace[s][alive].mean())
                best_lp = float(lp_trace[s][alive].max())
                best_criterion = -float(T_trace[s]) * best_lp
            else:
                mean_lp = best_lp = float("-inf")
                best_criterion = float("inf")
            print(
                f"svgd iter {s + 1}/{n_steps}: "
                f"T={float(T_trace[s]):.6g}, "
                f"bandwidth={float(bw_trace[s]):.6g}, "
                f"n_alive={n_alive}/{n_eff}, "
                f"mean_log_prob={mean_lp:.6g}, "
                f"best_log_prob={best_lp:.6g}, "
                f"best_criterion={best_criterion:.6g}, "
                f"mean_velocity_norm={float(vel_trace[s]):.6g}"
            )

    def safe_lp(t):
        v = gnp._tensor(log_prob(t)).reshape(())
        return torch.where(torch.isnan(v), -math.inf, v)

    with torch.no_grad():
        if route == "particles":
            final_log_probs = torch.stack([safe_lp(t) for t in particles])
        else:
            final_log_probs = torch.func.vmap(safe_lp)(particles)

    info = {
        "options": opts,
        "log_prob_trace": traces["log_prob_values"],
        "bandwidth_trace": traces["bandwidth"],
        "temperature_trace": traces["temperature"],
        "velocity_norm_trace": traces["velocity_norm"],
        "log_prob_final": final_log_probs,
        "particles_final": particles,
        "route": route,
    }
    if store_history and n_steps > 0:
        info["particles_history"] = torch.stack(history)
    return particles, info


def plot_svgd_empirical_distributions(particles_or_info, parameter_indices=None,
                                      parameter_indices_pooled=None, bins=50):
    """Marginal histograms (+ KDE) of an SVGD particle cloud."""
    import matplotlib.pyplot as plt
    from scipy import stats

    if isinstance(particles_or_info, dict):
        particles = np.asarray(gnp.to_np(particles_or_info["particles_final"]))
        lp = np.asarray(gnp.to_np(particles_or_info["log_prob_final"]))
        particles = particles[np.isfinite(lp)]
    else:
        particles = np.asarray(gnp.to_np(gnp.asarray(particles_or_info)))
    dim = particles.shape[1]

    figs = {"individual": None, "pooled": None}
    if parameter_indices is None and parameter_indices_pooled is None:
        parameter_indices = list(range(dim))

    if parameter_indices is not None:
        n = len(parameter_indices)
        fig, axes = plt.subplots(n, 1, figsize=(8, min(9, 2.5 * n)))
        if n == 1:
            axes = [axes]
        for k, p in enumerate(parameter_indices):
            data = particles[:, p]
            axes[k].hist(data, bins=bins, density=True, alpha=0.6)
            if data.shape[0] > 2 and data.std() > 0:
                xs = np.linspace(data.min(), data.max(), 200)
                axes[k].plot(xs, stats.gaussian_kde(data)(xs))
            axes[k].set_ylabel(f"param {p}")
        plt.tight_layout()
        figs["individual"] = fig

    if parameter_indices_pooled is not None:
        fig, ax = plt.subplots(figsize=(8, 5))
        for p in parameter_indices_pooled:
            ax.hist(particles[:, p], bins=bins, density=True, alpha=0.4,
                    label=f"param {p}")
        ax.legend()
        plt.tight_layout()
        figs["pooled"] = fig

    plt.show()
    return figs
