# gpmp_tpu_torch/mcmc/mh.py
"""Adaptive Metropolis-Hastings (counterpart of gpmp_tpu/mcmc/mh.py).

Multi-chain random-walk MH with Robbins-Monro or Haario adaptation, a
burn-in scheduler with early stopping (sliding acceptance band and
Gelman-Rubin), sliding acceptance rates, Gelman-Rubin and KS diagnostics,
and checkpoint / resume.

Design:
- The chains' states and log-target values live on the configured device
  (the card unless the CPU was asked for).  A block of steps is a Python
  loop; each step proposes for every chain at once, evaluates the log
  target chain after chain (one criterion call each: the port's gram
  kernels have no batching rule, so there is no vmap), and accepts by
  ``torch.where``, with no read back to the host inside the block.
- Random numbers come from one ``torch.Generator`` on the CPU, seeded from
  ``MHOptions.seed``: each step draws its proposal normals (chains x dim)
  then its uniforms (chains); a block's draws are made together and moved
  to the device.  One seed thus gives the same draws on the card and on
  the CPU, and the stream does not depend on how steps are grouped into
  blocks or dispatches.  A checkpoint holds the generator's state.
- The traces (``x``, ``accept``, ``log_target_values``) are host NumPy
  arrays, copied back from the device once a block.
- Non-finite log-target values behave as -inf (rejection).
"""

import math
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.config import get_logger


def check_chain_mesh(mesh):
    """A chain (or particle) mesh is None, or a port mesh
    (``parallel.make_mesh``) that spans one device; chains and particles
    sharded over more devices are not ported."""
    if mesh is None:
        return
    from gpmp_tpu_torch.parallel.mesh import Mesh

    if isinstance(mesh, Mesh) and mesh.size == 1:
        return
    raise NotImplementedError(
        "sharding chains or particles over a mesh of more than one device is not "
        "ported (ROADMAP queue 1, item 10c); pass mesh=None or a one-device "
        "gpmp_tpu_torch.parallel.make_mesh() mesh"
    )


def _new_generator(seed):
    """A CPU torch.Generator seeded from ``seed`` (a fresh random seed when
    None, as the JAX package's PRNGKey from the global NumPy generator)."""
    if seed is None:
        seed = int(np.random.default_rng().integers(2**31))
    return torch.Generator().manual_seed(int(seed))


def sample_multivariate_normal_with_jitter(mean, cov, initial_jitter=1e-8,
                                           max_attempts=5, generator=None):
    """Draw one mvn sample, escalating diagonal jitter if the Cholesky
    factorization produces NaNs (reference mh.py:59-77).  ``generator``: a
    torch.Generator (the module-level one of ``gnp`` when None)."""
    cov = gnp.asarray(cov)
    dim = cov.shape[0]
    mean = gnp.asarray(mean).reshape(-1)
    gen = gnp._generator(generator)
    jitter = 0.0
    for _ in range(max_attempts + 1):
        cov_try = cov if jitter == 0.0 else cov + jitter * gnp.eye(dim)
        L = gnp.cholesky(cov_try)
        if not bool(torch.isnan(L).any()):
            eps = torch.randn((dim,), generator=gen, dtype=cov.dtype, device=gen.device)
            return mean + L @ eps.to(cov.device)
        jitter = initial_jitter if jitter == 0.0 else 10.0 * jitter
    raise RuntimeError(
        "Covariance matrix is not positive definite even after adding jitter."
    )


def _mh_steps(batched_lt, x0, lt0, propose, log_u):
    """Advance every chain ``len(log_u)`` steps: ``propose(t, x)`` gives the
    chains' proposals at step t, accepted where log_u[t] < lt_y - lt.
    Returns (xs (n, C, d), accepts (n, C) bool, lts (n, C)), on the device
    of x0."""
    x, lt = x0, lt0
    xs, accepts, lts = [], [], []
    for t in range(log_u.shape[0]):
        y = propose(t, x)
        lt_y = batched_lt(y)
        accept = log_u[t] < lt_y - lt
        x = torch.where(accept[:, None], y, x)
        lt = torch.where(accept, lt_y, lt)
        xs.append(x)
        accepts.append(accept)
        lts.append(lt)
    return torch.stack(xs), torch.stack(accepts), torch.stack(lts)


def _mh_block(batched_lt, x0, lt0, chols, eps, u):
    """Random-walk steps: x0 (C, d), lt0 (C,), chols (C, d, d) the per-chain
    proposal Cholesky factors; eps (n, C, d) standard normals and u (n, C)
    uniforms, floored at 1e-300, as the JAX package's block kernel derives
    them per step (gpmp_tpu/mcmc/mh.py:293-304)."""
    steps = torch.einsum("cij,ncj->nci", chols, eps)
    return _mh_steps(batched_lt, x0, lt0, lambda t, x: x + steps[t],
                     torch.log(torch.clamp_min(u, 1e-300)))


@dataclass
class MHOptions:
    """Configuration of the Metropolis-Hastings sampler.

    Every field of the JAX package's MHOptions is kept.  The dispatch
    fields (``blocks_per_dispatch``, ``burnin_in_graph``,
    ``max_steps_per_dispatch``) tune the TPU's device programs there; here
    they only set what a user can observe: where the burn-in's early-stop
    checks fire (after every adaptation block with ``burnin_in_graph``
    where it applies, else after every ``blocks_per_dispatch`` blocks) and
    where checkpoints land (once per group of blocks, and every
    ``max_steps_per_dispatch`` steps of a long frozen phase).  The draws,
    and so the trajectories up to an early stop, do not depend on them.
    """

    dim: int = 1
    n_chains: int = 1
    symmetric: bool = True
    target_acceptance: float = 0.3
    acceptance_tol: float = 0.15
    adaptation_method: str = "Haario"
    proposal_distribution_param_init: Optional[Any] = field(default=None)
    adaptation_interval: int = 50
    freeze_adaptation: bool = True
    discard_burnin: bool = False
    n_pool: int = 1
    RM_adapt_factor: float = 1.0
    RM_diminishing: bool = True
    haario_adapt_factor_burnin_phase: float = 1.0
    haario_adapt_factor_sampling_phase: float = 0.5
    haario_initial_scaling_factor: float = 1.0
    sliding_rate_width: int = 200
    show_global_progress: bool = False
    progress_interval: int = 200
    init_msg: Optional[str] = field(
        default="Sampling from target distribution..."
    )
    seed: Optional[int] = None
    # None, or a one-device mesh of gpmp_tpu_torch.parallel.make_mesh
    # (check_chain_mesh); the chains then run on that device as without it
    mesh: Optional[Any] = None
    mesh_axis_name: str = "chains"
    # checkpoint/resume: when checkpoint_path is set, the full sampler
    # state (the generator's included) is written there every
    # checkpoint_every groups of adaptation blocks, and every
    # max_steps_per_dispatch steps of a frozen phase; resume with
    # MetropolisHastings.restore_checkpoint + continue_run
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 10
    max_steps_per_dispatch: int = 20_000
    # adaptation blocks run between two early-stop checks (and between two
    # checkpoint opportunities) when the per-block checks of
    # burnin_in_graph do not apply
    blocks_per_dispatch: int = 1
    # early-stop checks after every adaptation block of the burn-in,
    # whatever blocks_per_dispatch is; as in the JAX package it does not
    # apply (the checks follow blocks_per_dispatch) when checkpointing is
    # on, a custom prop_rnd is set, a mesh is given, diag is off, the
    # diagnostic window is shorter than sliding_rate_width, or the burn-in
    # resumes past its start
    burnin_in_graph: bool = True

    def __post_init__(self):
        if self.proposal_distribution_param_init is None:
            self.proposal_distribution_param_init = np.ones(self.dim)
        self.acceptance_min = self.target_acceptance - self.acceptance_tol
        self.acceptance_max = self.target_acceptance + self.acceptance_tol


class MetropolisHastings:
    """Multi-chain adaptive random-walk MH.

    Traces after ``scheduler``: ``x`` (n_chains, 1 + n_steps, dim),
    ``accept`` (n_chains, 1 + n_steps), ``log_target_values``; all
    host-side numpy (appended block by block from the device).

    ``log_target(x)`` takes one chain's state, a tensor of shape (dim,) on
    the configured device, and returns a scalar (tensor or float).
    ``prop_rnd(generator, x) -> y``, if given, replaces the Gaussian random
    walk: ``generator`` is the sampler's CPU torch.Generator, ``x`` one
    chain's state on the device; ``y`` has shape (dim,).  A block then
    draws its uniforms first, then each step's proposals.
    """

    def __init__(self, log_target, prop_rnd=None, options: MHOptions = None):
        self.options = options or MHOptions()
        self.log_target = log_target
        self.prop_rnd = prop_rnd

        self.n_chains = self.options.n_chains
        self.dim = self.options.dim
        check_chain_mesh(self.options.mesh)
        if prop_rnd is not None:
            # shape probe on a throwaway generator: the sampler's stream is
            # not touched
            out = prop_rnd(torch.Generator().manual_seed(0), gnp.zeros(self.dim))
            shape = tuple(getattr(out, "shape", np.shape(out)))
            if shape != (self.dim,):
                raise ValueError(
                    f"prop_rnd must return shape ({self.dim},), got {shape}"
                )
            self._warned_prop_rnd_adaptation = False
        self.symmetric = self.options.symmetric
        self.target_acceptance = self.options.target_acceptance

        self.proposal_distribution_params = None
        self.haario_adapt_factor = None
        init_scale = self.options.haario_initial_scaling_factor
        if init_scale is None:
            init_scale = 2.38**2 / self.dim
        self.haario_scaling_factors = np.full(self.n_chains, float(init_scale))

        self.x = None
        self.log_target_values = None
        self.accept = None
        self.rates = None

        self.sampling_mode = "init"
        self.burnin_period = 0
        self.global_iter = 0
        self.global_total = 0
        self.start_time = None

        self._generator = _new_generator(self.options.seed)
        self._blocks_since_checkpoint = 0

    # ------------------------------------------------------------------
    # log target and the block step
    # ------------------------------------------------------------------
    def _safe_log_target(self, x):
        v = gnp.asarray(self.log_target(x)).reshape(())
        return torch.where(torch.isnan(v), -math.inf, v)

    def _batched_target(self, xs):
        """Log targets of the rows of xs (C, dim), chain after chain, NaN
        mapped to -inf."""
        v = torch.stack([gnp.asarray(self.log_target(xs[c])).reshape(())
                         for c in range(xs.shape[0])])
        return torch.where(torch.isnan(v), -math.inf, v)

    def _draw_block(self, n_steps):
        """The block's proposal normals (n, C, d) and uniforms (n, C), drawn
        step by step on the CPU generator, then moved to the device."""
        g, C, d, dt = self._generator, self.n_chains, self.dim, gnp.get_dtype()
        eps = torch.empty((n_steps, C, d), dtype=dt)
        u = torch.empty((n_steps, C), dtype=dt)
        for t in range(n_steps):
            eps[t] = torch.randn((C, d), generator=g, dtype=dt)
            u[t] = torch.rand((C,), generator=g, dtype=dt)
        return gnp.asarray(eps), gnp.asarray(u)

    def _run_block(self, n_steps, chols):
        """n_steps steps from the current state with fixed proposal factors;
        writes the traces and returns the per-chain acceptance rates."""
        i0 = self.global_iter + 1
        lt0_np = self.log_target_values[:, self.global_iter].copy()
        x0 = gnp.asarray(self.x[:, self.global_iter, :].copy())
        lt0 = gnp.asarray(lt0_np)
        with torch.no_grad():
            if np.any(np.isnan(lt0_np)):
                # NaN marks "not yet evaluated" (fresh or restored chains)
                lt0 = torch.where(torch.isnan(lt0), self._batched_target(x0), lt0)
            if self.prop_rnd is None:
                eps, u = self._draw_block(n_steps)
                xs, accepts, lts = _mh_block(self._batched_target, x0, lt0,
                                             gnp.asarray(chols), eps, u)
            else:
                # the block's uniforms, then each step's proposals
                g = self._generator
                u = torch.rand((n_steps, self.n_chains), generator=g, dtype=x0.dtype)

                def propose(t, x):
                    return torch.stack([gnp.asarray(self.prop_rnd(g, x[c])).reshape(x.shape[1:])
                                        for c in range(x.shape[0])])

                xs, accepts, lts = _mh_steps(self._batched_target, x0, lt0, propose,
                                             gnp.asarray(torch.log(torch.clamp_min(u, 1e-300))))
        # one transfer for the block's traces
        C, d = self.n_chains, self.dim
        flat = torch.cat([xs.reshape(-1), accepts.reshape(-1).to(xs.dtype),
                          lts.reshape(-1)]).to(device="cpu", dtype=torch.float64).numpy()
        m = n_steps * C
        xs = flat[: m * d].reshape(n_steps, C, d)
        acc = flat[m * d : m * d + m].reshape(n_steps, C) > 0.5
        lts = flat[m * d + m :].reshape(n_steps, C)
        self.x[:, i0 : i0 + n_steps, :] = np.swapaxes(xs, 0, 1)
        self.accept[:, i0 : i0 + n_steps] = np.swapaxes(acc, 0, 1)
        self.log_target_values[:, i0 : i0 + n_steps] = np.swapaxes(lts, 0, 1)
        self.global_iter += n_steps
        return acc.mean(axis=0)

    def _proposal_chols(self):
        """(n_chains, dim, dim) Cholesky factors of per-chain proposal covs."""
        chols = np.empty((self.n_chains, self.dim, self.dim))
        for c in range(self.n_chains):
            cov = np.asarray(self._get_cov_parameter(c), dtype=float)
            chols[c] = np.linalg.cholesky(cov + 0.0)
        return chols

    def _get_cov_parameter(self, chain_idx):
        p = np.asarray(gnp.to_np(self.proposal_distribution_params[chain_idx]))
        if p.ndim == 0:
            return float(p) * np.eye(self.dim)
        if p.ndim == 1:
            return np.diag(p)
        if p.ndim == 2:
            return p
        raise ValueError("proposal_params must be scalar, 1D, or 2D per chain.")

    def _initialize_proposal_distribution_params(self, p_init):
        p_init = np.asarray(gnp.to_np(p_init), dtype=float)
        if p_init.ndim == 1 and p_init.shape[0] == self.dim:
            return [p_init.copy() for _ in range(self.n_chains)]
        if p_init.ndim == 2 and p_init.shape == (self.dim, self.dim):
            return [p_init.copy() for _ in range(self.n_chains)]
        if p_init.ndim == 3 and p_init.shape[0] == self.n_chains:
            return [p_init[i].copy() for i in range(self.n_chains)]
        raise ValueError("Invalid proposal_param_init shape.")

    # ------------------------------------------------------------------
    # block runner
    # ------------------------------------------------------------------
    def run_samples(self, n_steps, show_global_progress=False):
        """Advance all chains n_steps with the current proposal; returns
        per-chain block acceptance rates.  Requests longer than
        max_steps_per_dispatch run in pieces, with a checkpoint
        opportunity after each (the draws are the same)."""
        if n_steps <= 0:
            return np.zeros(self.n_chains)
        cap = max(1, int(self.options.max_steps_per_dispatch))
        if n_steps > cap:
            rates_sum = np.zeros(self.n_chains)
            done = 0
            while done < n_steps:
                k = min(cap, n_steps - done)
                rates_sum += self.run_samples(k, show_global_progress) * k
                done += k
                self._maybe_checkpoint()
            return rates_sum / n_steps
        rates = self._run_block(n_steps, self._proposal_chols())
        if show_global_progress and (
            self.global_iter % self.options.progress_interval < n_steps
        ):
            self._print_progress(self.global_iter, self.global_total,
                                 self.start_time)
        return rates

    # ------------------------------------------------------------------
    # adaptation
    # ------------------------------------------------------------------
    def _diminishing_adaptation_schedule(self, n, n_total, base, final_frac=0.1):
        cosine_component = math.cos(math.pi * n / max(n_total, 1))
        return base * (final_frac + (1 - final_frac) * cosine_component)

    def run_adaptive_RM(self, n_block_size, diminishing=True, _checkpoint=True):
        """Robbins-Monro scale adaptation toward the target acceptance."""
        gamma_base = self.options.RM_adapt_factor
        rates = self.run_samples(
            n_block_size, show_global_progress=self.options.show_global_progress
        )
        if diminishing:
            gamma = self._diminishing_adaptation_schedule(
                self.global_iter, self.burnin_period, gamma_base, final_frac=0.1
            )
        else:
            gamma = gamma_base
        for c in range(self.n_chains):
            self.proposal_distribution_params[c] = self.proposal_distribution_params[
                c
            ] * math.exp(gamma * (float(rates[c]) - self.target_acceptance))
        if _checkpoint:
            self._maybe_checkpoint()

    def _compute_covariances_for_block(self, x_block, n_pool=1):
        n_chains = x_block.shape[0]
        if n_chains % n_pool != 0:
            raise ValueError("n_chains must be divisible by n_pool.")
        n_groups = n_chains // n_pool
        covs = np.empty((n_groups, self.dim, self.dim))
        for i, start in enumerate(range(0, n_chains, n_pool)):
            grp = x_block[start : start + n_pool].reshape(-1, self.dim)
            covs[i] = np.cov(grp.T, ddof=1).reshape(self.dim, self.dim)
        return covs

    def update_proposal_covariance_from_samples(self, x_chain=None, raw_cov=None,
                                                scaling=None, epsilon=1e-6):
        """Haario update: new_cov = scaling * EmpCov + epsilon * I."""
        if (x_chain is None) == (raw_cov is None):
            raise ValueError("Must supply exactly one of x_chain or raw_cov.")
        if scaling is None:
            scaling = 2.38**2 / self.dim
        used_cov = (
            raw_cov if raw_cov is not None
            else np.cov(np.asarray(x_chain).T, ddof=1).reshape(self.dim, self.dim)
        )
        return scaling * np.asarray(used_cov) + epsilon * np.eye(self.dim)

    def default_prop_rnd(self, x, chain_idx):
        """Random-walk proposal N(x, Cov_chain) (reference mh.py:298-305),
        drawn from the sampler's generator."""
        cov = self._get_cov_parameter(chain_idx)
        return np.asarray(x) + gnp.to_np(
            sample_multivariate_normal_with_jitter(
                np.zeros(self.dim), cov, generator=self._generator
            )
        )

    def mhstep(self, x_current, chain_idx, log_target_x_current=None):
        """Single host-level MH update for one chain (reference
        mh.py:379-426).  The block step is the production path; this
        mirrors the reference's one-step API for parity/debugging.
        Returns (x_next, accepted, log_target_next, log_target_current)."""
        x_current = np.asarray(gnp.to_np(x_current))
        with torch.no_grad():
            if log_target_x_current is None or np.isnan(log_target_x_current):
                log_target_x_current = float(
                    self._safe_log_target(gnp.asarray(x_current))
                )
            if self.prop_rnd is not None:
                y = np.asarray(gnp.to_np(self.prop_rnd(self._generator,
                                                       gnp.asarray(x_current))))
            else:
                y = self.default_prop_rnd(x_current, chain_idx)
            log_target_y = float(self._safe_log_target(gnp.asarray(y)))
        log_a = log_target_y - log_target_x_current
        u = max(float(torch.rand((), generator=self._generator, dtype=torch.float64)),
                1e-300)
        if math.log(u) < log_a:
            return y, True, log_target_y, log_target_x_current
        return x_current, False, log_target_x_current, log_target_x_current

    def compute_empirical_covariance_whole_chain(self, burnin=None,
                                                 pooled=False, n_pool=1):
        """Empirical covariance(s) of post-burnin samples: one pooled
        matrix or a list per chain group (reference mh.py:1197-1213)."""
        if burnin is None:
            burnin = self.burnin_period
        if self.x is None:
            raise ValueError("No samples yet.")
        if pooled:
            big = self.x[:, burnin:].reshape(-1, self.dim)
            return np.cov(big.T, ddof=1).reshape(self.dim, self.dim)
        x_pooled = self._get_pooled_samples(burnin, n_pool)
        return [np.cov(x.T, ddof=1).reshape(self.dim, self.dim)
                for x in x_pooled]

    def recompute_all_chains_full_covariance(self, burnin=None, scaling=None,
                                             epsilon=1e-6):
        """Refresh every chain's proposal covariance from its post-burnin
        samples (Haario; reference mh.py:1181-1194)."""
        if burnin is None:
            burnin = self.burnin_period
        if self.x is None:
            raise ValueError("No chain data available.")
        for c in range(self.n_chains):
            self.proposal_distribution_params[c] = (
                self.update_proposal_covariance_from_samples(
                    x_chain=self.x[c, burnin:], scaling=scaling,
                    epsilon=epsilon
                )
            )

    def run_adaptive_Haario(self, n_block_size, epsilon=1e-6, _checkpoint=True):
        """Haario covariance adaptation per chain group."""
        block_rates = self.run_samples(
            n_block_size, show_global_progress=self.options.show_global_progress
        )
        i0 = self.global_iter - n_block_size + 1
        i1 = self.global_iter + 1
        covs = self._compute_covariances_for_block(
            self.x[:, i0:i1, :], self.options.n_pool
        )
        for c in range(self.n_chains):
            grp = c // self.options.n_pool
            self.haario_scaling_factors[c] *= math.exp(
                self.haario_adapt_factor
                * (float(block_rates[c]) - self.target_acceptance)
            )
            self.proposal_distribution_params[c] = (
                self.update_proposal_covariance_from_samples(
                    raw_cov=covs[grp],
                    scaling=self.haario_scaling_factors[c],
                    epsilon=epsilon,
                )
            )
        if _checkpoint:
            self._maybe_checkpoint()

    def run_adaptive_RM_blocks(self, n_blocks, n_block_size, diminishing=True):
        """n_blocks RM adaptation blocks, then one checkpoint opportunity
        (the JAX package runs them as one device program)."""
        for _ in range(n_blocks):
            self.run_adaptive_RM(n_block_size, diminishing=diminishing,
                                 _checkpoint=False)
        self._maybe_checkpoint()

    def run_adaptive_Haario_blocks(self, n_blocks, n_block_size):
        """n_blocks Haario adaptation blocks, then one checkpoint
        opportunity (the JAX package runs them as one device program)."""
        for _ in range(n_blocks):
            self.run_adaptive_Haario(n_block_size, _checkpoint=False)
        self._maybe_checkpoint()

    def _run_blocks(self, method, k, diminishing):
        """k adaptation blocks of ``method``: one group (one checkpoint
        opportunity)."""
        block = self.options.adaptation_interval
        if method == "haario":
            self.run_adaptive_Haario_blocks(k, block)
        else:
            self.run_adaptive_RM_blocks(k, block, diminishing=diminishing)

    def _maybe_checkpoint(self):
        """Periodic checkpoint at the end of a group of adaptation blocks
        (after the proposal update, so a resumed run replays the exact
        state the uninterrupted run would have used next)."""
        if self.options.checkpoint_path is None:
            return
        self._blocks_since_checkpoint += 1
        if self._blocks_since_checkpoint >= max(
            1, self.options.checkpoint_every
        ):
            self.save_checkpoint(self.options.checkpoint_path)
            self._blocks_since_checkpoint = 0

    def run_adaptive(self, n_samples):
        if self._adaptation_bypass(n_samples):
            return
        n_blocks = n_samples // self.options.adaptation_interval
        remainder = n_samples - n_blocks * self.options.adaptation_interval
        method = self.options.adaptation_method.lower()
        if method not in ("rm", "haario"):
            raise ValueError("adaptation_method must be 'RM' or 'Haario'.")
        K = max(1, int(self.options.blocks_per_dispatch))
        block = 0
        while block < n_blocks:
            k = min(K, n_blocks - block)
            self._run_blocks(method, k, diminishing=False)
            block += k
        if remainder > 0:
            self.run_samples(
                remainder, show_global_progress=self.options.show_global_progress
            )

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    def set_mode(self, mode):
        self.sampling_mode = mode
        if mode == "burnin":
            self.haario_adapt_factor = self.options.haario_adapt_factor_burnin_phase
        elif mode == "sampling_adaptation":
            self.haario_adapt_factor = (
                self.options.haario_adapt_factor_sampling_phase
            )

    def _adaptation_bypass(self, n_samples):
        """With a custom prop_rnd there is nothing to adapt: Haario/RM
        tune the Gaussian random walk the custom proposal replaces.  Run
        the fixed proposal instead (warning once)."""
        if self.prop_rnd is None:
            return False
        if not self._warned_prop_rnd_adaptation:
            get_logger().warning(
                "custom prop_rnd replaces the Gaussian random walk, so "
                "Haario/RM adaptation does not apply; running the "
                "adaptation/burn-in phase with the fixed custom proposal."
            )
            self._warned_prop_rnd_adaptation = True
        self.run_samples(
            n_samples, show_global_progress=self.options.show_global_progress
        )
        return True

    def _checks_every_block(self, n_blocks, n_diag_samples):
        """Whether the burn-in's early-stop checks fire after every block
        (the JAX package's in-graph burn-in, where it applies)."""
        opts = self.options
        return (
            opts.burnin_in_graph
            and n_blocks >= 1
            and opts.checkpoint_path is None
            and self.prop_rnd is None
            and opts.mesh is None
            and n_diag_samples >= max(1, int(opts.sliding_rate_width))
            and self.global_iter == 0
        )

    def _burnin_converged(self, n_diag_samples):
        """Acceptance band and Gelman-Rubin over the trailing window."""
        rates = self.compute_sliding_rates(self.options.sliding_rate_width)
        i0 = max(0, self.global_iter - n_diag_samples)
        rates_w = rates[:, i0 : self.global_iter]
        min_ar = rates_w.min(axis=1)
        max_ar = rates_w.max(axis=1)
        if self.n_chains >= 2:
            gr = self.check_convergence_gelman_rubin(
                last_n_samples=n_diag_samples, verbose=False
            )
        else:
            gr = {"ok": True}
        return bool(
            np.all(min_ar > self.options.acceptance_min)
            and np.all(max_ar < self.options.acceptance_max)
            and gr.get("ok", False)
        )

    def run_burnin(self, burnin_period, diag=True, n_blocks_convergence_diag=20):
        """Burn-in block loop with early stopping on (acceptance window AND
        Gelman-Rubin) convergence (reference mh.py:534-618)."""
        if self._adaptation_bypass(burnin_period):
            return
        n_blocks = burnin_period // self.options.adaptation_interval
        remainder = burnin_period - n_blocks * self.options.adaptation_interval
        method = self.options.adaptation_method.lower()
        if method not in ("rm", "haario"):
            raise ValueError("adaptation_method must be 'RM' or 'Haario'.")
        n_diag_samples = n_blocks_convergence_diag * self.options.adaptation_interval
        converged_early = False

        K = max(1, int(self.options.blocks_per_dispatch))
        if diag and self._checks_every_block(n_blocks, n_diag_samples):
            K = 1

        block = 0
        while block < n_blocks:
            k = min(K, n_blocks - block)
            self._run_blocks(method, k, diminishing=self.options.RM_diminishing)
            block += k
            if (diag and self.global_iter >= n_diag_samples
                    and self._burnin_converged(n_diag_samples)):
                print(
                    f"\nEarly stopping: convergence detected during burn-in "
                    f"at iter = {self.global_iter}."
                )
                self.burnin_period = self.global_iter
                converged_early = True
                break

        if (not converged_early) and remainder > 0:
            self.run_samples(
                remainder, show_global_progress=self.options.show_global_progress
            )

        if diag:
            print("\nConvergence Diagnostics after burn-in:")
            if self.global_iter <= 1:
                print("Not enough samples to run diagnostics after burn-in.")
                return
            rates = self.compute_sliding_rates(self.options.sliding_rate_width)
            self.check_acceptance_rates(
                last_n_samples=n_diag_samples,
                rates=rates,
                low_threshold=self.options.acceptance_min,
                high_threshold=self.options.acceptance_max,
            )
            if self.n_chains >= 2:
                self.check_convergence_gelman_rubin(last_n_samples=n_diag_samples)

    def scheduler(self, chains_state_initial, n_steps_total, burnin_period,
                  replicate_initial_state=True):
        """Full run: burn-in (adaptive) then sampling (frozen or adaptive)."""
        chains_state_initial = np.asarray(gnp.to_np(chains_state_initial), dtype=float)
        if chains_state_initial.ndim == 1:
            chains_state_initial = chains_state_initial.reshape(1, -1)
        if (
            chains_state_initial.shape == (1, self.dim)
            and replicate_initial_state
            and self.n_chains > 1
        ):
            chains_state_initial = np.tile(chains_state_initial,
                                           (self.n_chains, 1))
        if chains_state_initial.shape != (self.n_chains, self.dim):
            raise ValueError(
                f"chains_state_initial must have shape "
                f"({self.n_chains}, {self.dim}) or be 1D if "
                f"replicate_initial_state=True. Got {chains_state_initial.shape}."
            )
        if n_steps_total < burnin_period:
            raise ValueError("Total steps < burnin")

        self.proposal_distribution_params = (
            self._initialize_proposal_distribution_params(
                self.options.proposal_distribution_param_init
            )
        )
        self.x = np.empty((self.n_chains, 1 + n_steps_total, self.dim))
        self.accept = np.zeros((self.n_chains, 1 + n_steps_total))
        self.log_target_values = np.full((self.n_chains, 1 + n_steps_total),
                                         np.nan)
        self.burnin_period = burnin_period
        self.global_iter = 0
        self.global_total = 1 + n_steps_total
        self.start_time = time.time()
        self.x[:, 0, :] = chains_state_initial
        self.accept[:, 0] = 1.0

        if self.options.init_msg is not None:
            print(self.options.init_msg)
            print(f"  Dimension: {self.dim}")
            print(f"  Total steps: {n_steps_total}")
            print(f"  Burn-in: {burnin_period}")
            print(f"  Chains: {self.n_chains}")

        self.set_mode("burnin")
        self.run_burnin(burnin_period)

        n_remain = n_steps_total - self.burnin_period
        if self.options.freeze_adaptation:
            self.set_mode("sampling_freeze_adaptation")
            self.run_samples(
                n_remain, show_global_progress=self.options.show_global_progress
            )
        else:
            self.set_mode("sampling_adaptation")
            self.run_adaptive(n_remain)

        return self._finish_run()

    def _finish_run(self):
        self.global_total = self.global_iter
        if self.options.show_global_progress:
            self._print_final_time(self.global_total, self.start_time)

        self.rates = self.compute_sliding_rates(self.options.sliding_rate_width)

        out = (
            self.x[:, self.burnin_period : self.global_total + 1]
            if self.options.discard_burnin
            else self.x[:, : self.global_total + 1]
        )
        return gnp.asarray(out)

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def get_state(self):
        """(arrays, meta) snapshot of the full sampler state; the generator's
        state is the uint8 array ``generator_state``."""
        arrays = {
            "x": self.x,
            "accept": self.accept,
            "log_target_values": self.log_target_values,
            "haario_scaling_factors": self.haario_scaling_factors,
            "generator_state": self._generator.get_state().numpy().copy(),
        }
        if self.proposal_distribution_params is not None:
            for c, p in enumerate(self.proposal_distribution_params):
                arrays[f"proposal_param_{c}"] = np.asarray(p)
        meta = {
            "kind": "MetropolisHastings",
            "n_chains": self.n_chains,
            "dim": self.dim,
            "sampling_mode": self.sampling_mode,
            "burnin_period": int(self.burnin_period),
            "global_iter": int(self.global_iter),
            "global_total": int(self.global_total),
            "haario_adapt_factor": self.haario_adapt_factor,
            "n_proposal_params": (
                0 if self.proposal_distribution_params is None
                else len(self.proposal_distribution_params)
            ),
        }
        return arrays, meta

    def set_state(self, arrays, meta):
        """Load a get_state() snapshot of this port.  A gpmp_tpu state (its
        ``key`` array, no generator state) is refused: carry it across with
        gpmp_tpu_torch.interop.mh_state_from_numpy and a seed."""
        if meta.get("kind") != "MetropolisHastings":
            raise ValueError(f"Not an MH checkpoint: {meta.get('kind')!r}")
        if (meta["n_chains"], meta["dim"]) != (self.n_chains, self.dim):
            raise ValueError(
                "Checkpoint shape mismatch: options give "
                f"({self.n_chains}, {self.dim}), checkpoint has "
                f"({meta['n_chains']}, {meta['dim']})."
            )
        if "generator_state" not in arrays:
            raise ValueError(
                "state without a generator_state (a gpmp_tpu state holds a "
                "JAX key): use gpmp_tpu_torch.interop.mh_state_from_numpy"
            )
        self._set_traces_and_adaptation(arrays, meta)
        self._generator.set_state(
            torch.from_numpy(np.array(arrays["generator_state"], dtype=np.uint8)))

    def _set_traces_and_adaptation(self, arrays, meta):
        self.x = np.array(arrays["x"], dtype=float)
        self.accept = np.array(arrays["accept"], dtype=float)
        self.log_target_values = np.array(arrays["log_target_values"], dtype=float)
        self.haario_scaling_factors = np.array(
            arrays["haario_scaling_factors"], dtype=float
        )
        n_pp = meta.get("n_proposal_params", 0)
        if n_pp:
            self.proposal_distribution_params = [
                np.array(arrays[f"proposal_param_{c}"], dtype=float) for c in range(n_pp)
            ]
        self.sampling_mode = meta["sampling_mode"]
        self.burnin_period = int(meta["burnin_period"])
        self.global_iter = int(meta["global_iter"])
        self.global_total = int(meta["global_total"])
        self.haario_adapt_factor = meta["haario_adapt_factor"]
        if self.start_time is None:
            self.start_time = time.time()

    def save_checkpoint(self, path):
        from .checkpoint import save_sampler_checkpoint

        arrays, meta = self.get_state()
        save_sampler_checkpoint(path, arrays, meta)

    def restore_checkpoint(self, path):
        """Load state saved by save_checkpoint into this sampler (the
        log-target and options are re-supplied by the constructor)."""
        from .checkpoint import load_sampler_checkpoint

        arrays, meta = load_sampler_checkpoint(path)
        self.set_state(arrays, meta)

    def continue_run(self):
        """Resume an interrupted scheduler() run from restored state:
        finishes the remaining burn-in and/or sampling steps and returns
        the same trace array scheduler() would have."""
        if self.x is None:
            raise ValueError("No state to continue from; restore first.")
        n_steps_total = self.global_total - 1
        self.start_time = time.time()
        if (
            self.sampling_mode in ("init", "burnin")
            and self.global_iter < self.burnin_period
        ):
            self.set_mode("burnin")
            self.run_burnin(self.burnin_period - self.global_iter)
        n_remain = n_steps_total - max(self.global_iter, self.burnin_period)
        if n_remain > 0:
            if self.options.freeze_adaptation:
                self.set_mode("sampling_freeze_adaptation")
                self.run_samples(
                    n_remain,
                    show_global_progress=self.options.show_global_progress,
                )
            else:
                self.set_mode("sampling_adaptation")
                self.run_adaptive(n_remain)
        return self._finish_run()

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def compute_sliding_rates(self, n_block_size):
        """Sliding-window acceptance rates, shape (n_chains, global_iter)."""
        if self.accept is None:
            raise ValueError(
                "No acceptance data available to compute sliding rates."
            )
        n_max = self.global_iter
        if n_max <= 0:
            return np.empty((self.n_chains, 0))
        window = min(max(1, int(n_block_size)), n_max)
        acc = self.accept[:, :n_max]
        cumsum = np.cumsum(acc, axis=1)
        rates = np.empty((self.n_chains, n_max))
        rates[:, :window] = cumsum[:, :window] / (np.arange(window) + 1)
        if n_max > window:
            rates[:, window:] = (cumsum[:, window:] - cumsum[:, :-window]) / window
        return rates

    def check_acceptance_rates(self, burnin_period=None, last_n_samples=None,
                               low_threshold=0.15, high_threshold=0.40,
                               rates=None, verbose=True):
        if burnin_period is None:
            burnin_period = self.burnin_period
        if rates is None:
            if self.rates is None:
                if verbose:
                    print("No sliding acceptance rates available.")
                return {}
            rates_data = self.rates
        else:
            rates_data = rates

        i0 = (
            burnin_period
            if last_n_samples is None
            else max(0, self.global_iter - last_n_samples)
        )
        i1 = self.global_iter
        if i1 - i0 <= 1:
            raise ValueError("Not enough samples to compute acceptance rates.")

        data = rates_data[:, i0:i1]
        min_ar = float(data.min())
        max_ar = float(data.max())
        ok = (min_ar >= low_threshold) and (max_ar <= high_threshold)
        if verbose:
            print("[check_acceptance_rates]")
            if not ok:
                if min_ar < low_threshold:
                    print(f"WARNING: Min acceptance rate ({min_ar:.3f}) is "
                          f"below the threshold of {low_threshold:.2f}.")
                if max_ar > high_threshold:
                    print(f"WARNING: Max acceptance rate ({max_ar:.3f}) is "
                          f"above the threshold of {high_threshold:.2f}.")
            else:
                print("PASS: Acceptance rates within tolerance bounds")
            print(f"  Min = {min_ar:.3f},  Max = {max_ar:.3f}")
        return {"min_ar": min_ar, "max_ar": max_ar, "ok": ok}

    def compute_gelman_rubin_rhat(self, burnin_period=None, last_n_samples=None):
        """Split-free Gelman-Rubin R-hat per parameter."""
        if burnin_period is None:
            burnin_period = self.burnin_period
        if self.x is None:
            raise ValueError("No chain data available.")
        if self.n_chains < 2:
            raise ValueError("At least 2 chains are required.")
        i0 = (
            burnin_period
            if last_n_samples is None
            else max(0, self.global_iter - last_n_samples)
        )
        i1 = self.global_iter
        n_block = i1 - i0
        if n_block <= 1:
            raise ValueError(
                "Not enough samples to compute Gelman-Rubin diagnostic."
            )
        block = self.x[:, i0:i1, :]
        chain_means = block.mean(axis=1)
        chain_vars = block.var(axis=1, ddof=1)
        W = chain_vars.mean(axis=0)
        B = n_block * chain_means.var(axis=0, ddof=1)
        var_post = ((n_block - 1) / n_block) * W + B / n_block
        # degenerate within-chain variance: R-hat = inf if the chains
        # disagree, 1.0 if they all sit on one value
        with np.errstate(divide="ignore", invalid="ignore"):
            rhat = np.sqrt(var_post / W)
        degenerate = W == 0.0
        if np.any(degenerate):
            rhat = np.where(degenerate & (var_post > 0.0), np.inf, rhat)
            rhat = np.where(degenerate & (var_post == 0.0), 1.0, rhat)
        return rhat

    def check_convergence_gelman_rubin(self, burnin_period=0, last_n_samples=None,
                                       threshold=1.1, verbose=True):
        rhat = self.compute_gelman_rubin_rhat(
            burnin_period=burnin_period, last_n_samples=last_n_samples
        )
        ok = bool(np.all(rhat < threshold))
        if verbose:
            if ok:
                print(f"[check_gelman_rubin_rhat]\nPASS: All R-hat < {threshold}.")
            else:
                print(f"[check_gelman_rubin_rhat]\nWARNING: Some R-hat >= "
                      f"{threshold}.")
            print(f"  R-hat values: {rhat}")
        return {"rhat": rhat, "ok": ok}

    def ks_statistics(self, n_blocks, n_block_size, alpha=0.01,
                      return_significance=True, return_statistic=False):
        """Pairwise two-sample KS tests between trailing blocks of each
        chain (per dimension); high significant fraction flags
        non-convergence."""
        from scipy.stats import ks_2samp

        if self.x is None:
            raise ValueError("No chain data available. Run sampler first.")
        n_chains, n_steps, dim = self.x.shape
        needed = n_blocks * n_block_size
        if needed > n_steps:
            raise ValueError(
                f"Requested {n_blocks} blocks of size {n_block_size} "
                f"({needed} total) but chain only has {n_steps} samples."
            )
        blocks = []
        start_index = n_steps - needed
        for chain_idx in range(n_chains):
            for b in range(n_blocks):
                s = start_index + b * n_block_size
                blocks.append(self.x[chain_idx, s : s + n_block_size, :])
        B = len(blocks)
        pvalue_matrix = np.zeros((dim, B, B))
        ks_matrix = np.zeros((dim, B, B)) if return_statistic else None
        for d in range(dim):
            for i in range(B):
                for j in range(i + 1, B):
                    result = ks_2samp(blocks[i][:, d], blocks[j][:, d],
                                      alternative="two-sided")
                    if return_statistic:
                        ks_matrix[d, i, j] = ks_matrix[d, j, i] = result.statistic
                    pvalue_matrix[d, i, j] = pvalue_matrix[d, j, i] = result.pvalue
        if return_significance:
            significance = pvalue_matrix < alpha
            if return_statistic:
                return ks_matrix, pvalue_matrix, significance
            return pvalue_matrix, significance
        if return_statistic:
            return ks_matrix, pvalue_matrix
        return pvalue_matrix

    def check_convergence_ks(self, multi_block_n_blocks=5, multi_block_size=100,
                             single_block_size=None, alpha=0.01,
                             fraction_threshold=0.5, verbose=True):
        if self.x is None:
            raise ValueError("No chain data. Please run or load the sampler first.")
        n_chains, n_steps, dim = self.x.shape
        needed_multi = multi_block_n_blocks * multi_block_size
        if n_steps < needed_multi:
            raise ValueError(
                f"Need at least {needed_multi} samples for multi-block check."
            )
        _ksA, _pA, sigA = self.ks_statistics(
            n_blocks=multi_block_n_blocks, n_block_size=multi_block_size,
            alpha=alpha, return_significance=True, return_statistic=True,
        )
        frac_sig_multi = float(sigA.sum() / sigA.size)

        if single_block_size is None:
            single_block_size = needed_multi
        if n_steps < single_block_size:
            raise ValueError(
                f"Need at least {single_block_size} samples for "
                f"single-block check."
            )
        _ksB, _pB, sigB = self.ks_statistics(
            n_blocks=1, n_block_size=single_block_size, alpha=alpha,
            return_significance=True, return_statistic=True,
        )
        frac_sig_single = float(sigB.sum() / sigB.size)

        ok = (frac_sig_multi < fraction_threshold) and (
            frac_sig_single < fraction_threshold
        )
        results = {
            "multi_block": {
                "n_blocks": multi_block_n_blocks,
                "block_size": multi_block_size,
                "frac_significant": frac_sig_multi,
            },
            "single_block": {
                "n_blocks": 1,
                "block_size": single_block_size,
                "frac_significant": frac_sig_single,
            },
            "ok": ok,
        }
        if verbose:
            print("[check_convergence_ks]")
            print("PASS: Both KS checks below threshold." if ok
                  else "WARNING: At least one KS check exceeded threshold.")
            print(f"  Multi-block: frac_significant = {frac_sig_multi:.2%} "
                  f"(blocks = {multi_block_n_blocks} x {multi_block_size})")
            print(f"  Single-block: frac_significant = {frac_sig_single:.2%} "
                  f"(1 x {single_block_size})")
            print(f"  Threshold = {fraction_threshold:.2%}, alpha = {alpha}")
        return results

    # ------------------------------------------------------------------
    # progress + plots
    # ------------------------------------------------------------------
    def _print_progress(self, iteration, total_steps, start_time):
        elapsed = time.time() - start_time
        avg = elapsed / (iteration + 1)
        remaining = avg * (total_steps - (iteration + 1))
        pct = (iteration + 1) / total_steps * 100
        print(f"  Progress: {pct:5.2f}% | Time left: {remaining:5.1f}s      ",
              end="\r")

    def _print_final_time(self, total_steps, start_time):
        elapsed = time.time() - start_time
        print(f"  Progress: 100.00% complete | Total time: {elapsed:.3f}s")
        print(f"  Total proposals: {total_steps * self.n_chains}")

    def _get_pooled_samples(self, burnin=0, n_pool=1):
        if self.x is None:
            raise ValueError("No chain data yet.")
        if self.n_chains % n_pool != 0:
            raise ValueError("n_pool must divide n_chains")
        return [
            self.x[i : i + n_pool, burnin:].reshape(-1, self.dim)
            for i in range(0, self.n_chains, n_pool)
        ]

    def plot_chains(self, burnin=None, parameter_indices=None, show_rate=True):
        """Trace plots per dimension, optional acceptance-rate subplot."""
        import matplotlib.pyplot as plt

        if burnin is None:
            burnin = self.burnin_period
        if self.x is None:
            raise ValueError("No chain data.")
        pidx = parameter_indices or list(range(self.dim))
        n_plots = len(pidx)
        total_plots = n_plots + 1 if show_rate else n_plots
        height = min(9, 2.5 * total_plots)
        fig, axes = plt.subplots(total_plots, 1, figsize=(10, height),
                                 sharex=True)
        if total_plots == 1:
            axes = [axes]
        for k, p in enumerate(pidx):
            for c in range(self.n_chains):
                axes[k].plot(self.x[c, : self.global_iter, p], lw=0.5)
            axes[k].axvline(burnin, color="r", linestyle="--")
            axes[k].set_ylabel(f"param {p}")
        if show_rate and self.rates is not None:
            for c in range(self.n_chains):
                axes[-1].plot(self.rates[c], lw=0.5)
            axes[-1].set_ylabel("acc. rate")
            axes[-1].axhline(self.target_acceptance, color="k", linestyle=":")
        axes[-1].set_xlabel("iteration")
        plt.tight_layout()
        plt.show()
        return fig

    def plot_empirical_distributions(self, burnin=None, parameter_indices=None,
                                     bins=40):
        """Per-dimension marginal histograms pooled over chains."""
        import matplotlib.pyplot as plt

        if burnin is None:
            burnin = self.burnin_period
        pidx = parameter_indices or list(range(self.dim))
        fig, axes = plt.subplots(len(pidx), 1,
                                 figsize=(8, min(9, 2.5 * len(pidx))))
        if len(pidx) == 1:
            axes = [axes]
        for k, p in enumerate(pidx):
            data = self.x[:, burnin : self.global_iter, p].reshape(-1)
            axes[k].hist(data, bins=bins, density=True, alpha=0.7)
            axes[k].set_ylabel(f"param {p}")
        plt.tight_layout()
        plt.show()
        return fig
