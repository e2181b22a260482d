# gpmp_tpu_torch/mcmc/smc.py
"""Sequential Monte Carlo (tempering / subset simulation), counterpart of
gpmp_tpu/mcmc/smc.py.

ParticlesSet (reweight, ESS, multinomial and residual resampling, scaled
perturbation with jitter escalation, vectorized MH moves, blocks of them)
and the SMC driver after Bect, Li & Vazquez, "Bayesian subset simulation",
SIAM/ASA JUQ 5(1), 2017 (restart on ESS collapse with a tempering ladder
chosen by ESS brentq bisection or p0 dichotomy; checkpoint and resume);
run_smc_sampling and run_subset_simulation.

Design:
- The particle state (x, logpx, w) lives on the configured device (the
  card unless the CPU was asked for).  The log density is batched:
  ``logpdf(x)`` with x (n, d) returns (n,), one call for the whole
  population (on the parameter posterior a population criterion: K1p on the
  card, mcmc.population).
- Host work as in the JAX package: the resampling counts, the ladder
  searches (brentq / dichotomy), the proposal covariance and its Cholesky
  factor (NumPy) are O(n) scalar work between device stages; the ESS, a
  move's acceptance rate and a block's mean rate are one read each.
- ``move_block``'s sweeps are a Python loop, each accepted by
  ``torch.where``, read back once a block.
- Random numbers.  The NumPy ``rng`` draws the initial particles, the
  resampling counts and the k-NN seeds, as in the JAX package, so both
  packages start from the same particles.  The JAX package's key stream
  becomes a CPU ``torch.Generator`` seeded from the same
  ``rng.integers(2**31)``; the moves draw through three seams
  (``_draw_normals``, ``_draw_uniforms``, ``_draw_block``) in the order of
  the JAX package's key splits (a perturbation's normals, a move's
  uniforms, a block's per-sweep normals then uniforms), so that one seed
  gives the same draws on the card and on the CPU, and tests can replay the
  JAX package's draws.  A checkpoint holds the generator's state.
"""

import time
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from numpy.random import default_rng
from scipy.optimize import brentq
from scipy.stats import qmc

import gpmp_tpu_torch.num as gnp
from . import knn_cov
from .mh import check_chain_mesh


@dataclass
class ParticlesSetConfig:
    initial_distribution_type: str = "randunif"
    # None or a one-device mesh (parallel.make_mesh): the particles are not
    # sharded over more devices (ROADMAP queue 1, item 10c)
    mesh: Optional[Any] = None
    mesh_axis_name: str = "particles"
    resample_scheme: str = "multinomial"  # or "residual"
    param_s_initial_value: float = 0.5
    param_s_upper_bound: float = 1e5
    param_s_lower_bound: float = 1e-3
    jitter_initial_value: float = 1e-16
    jitter_max_iterations: int = 10
    covariance_method: str = "normal"  # or "knn"
    covariance_knn_n_random: int = 20
    covariance_knn_n_neighbors: int = 200


@dataclass
class SMCConfig:
    compute_next_logpdf_param_method: str = "p0"  # or "ess"
    mh_steps: int = 20
    # run the (mh_steps - 1) extra sweeps as one block with one proposal
    # factor and one read back; False refreshes the factor every sweep
    blocked_moves: bool = True
    mh_acceptation_rate_min: float = 0.15
    mh_acceptation_rate_max: float = 0.30
    mh_adjustment_factor: float = 1.4
    mh_adjustment_max_iterations: int = 50
    # checkpoint/resume: snapshot the full SMC state every checkpoint_every
    # tempering-ladder stages; resume with SMC.restore_checkpoint +
    # resume_restart
    checkpoint_path: str = None
    checkpoint_every: int = 1


class ParticlesSetError(BaseException):
    def __init__(self, param_s, lower, upper):
        super().__init__(
            "ParticlesSet: scaling parameter param_s in MH step out of range "
            f"(value: {param_s}, lower bound: {lower}, upper bound: {upper})."
        )


def _host(a):
    return np.asarray(gnp.to_np(a), dtype=float)


class ParticlesSet:
    """Particle cloud with reweight / resample / perturb / move operations.

    The log-density function must be batched: logpdf(x) with x (n, d)
    returns (n,).  The particles live on the configured device.
    """

    def __init__(self, box, n=1000, config: ParticlesSetConfig = None,
                 rng=None):
        self.n = n
        self.dim = len(box[0])
        self.rng = rng if rng is not None else default_rng()
        self.config = config if config is not None else ParticlesSetConfig()
        check_chain_mesh(self.config.mesh)
        self.param_s = self.config.param_s_initial_value
        self._generator = torch.Generator().manual_seed(int(self.rng.integers(2**31)))

        self.x = None
        self.logpx = None
        self.w = None
        self.w_tmp = None
        self.particles_init(box, n, method=self.config.initial_distribution_type)
        self.logpdf_function = None

    # -- RNG helpers kept as static methods for reference parity
    #    (reference smc.py:448-467)
    @staticmethod
    def rand(size, rng):
        return rng.uniform(size=size)

    @staticmethod
    def multinomial_rvs(n, p, rng):
        from scipy import stats

        return gnp.asarray(
            stats.multinomial.rvs(n=n, p=_host(p), random_state=rng)
        )

    @staticmethod
    def multivariate_normal_rvs(C, n, rng):
        from scipy import stats

        return gnp.asarray(
            stats.multivariate_normal.rvs(cov=_host(C), size=n, random_state=rng)
        )

    @staticmethod
    def randunif(dim, n, box, rng):
        return gnp.asarray(qmc.scale(rng.uniform(size=(n, dim)), box[0], box[1]))

    # -- the draw seams (the JAX package's key splits, in order)
    def _draw_normals(self, shape):
        """A perturbation's standard normals, on the particles' device."""
        return torch.randn(shape, generator=self._generator,
                           dtype=self.x.dtype).to(self.x.device)

    def _draw_uniforms(self, shape):
        """A move's uniforms, on the particles' device."""
        return torch.rand(shape, generator=self._generator,
                          dtype=self.x.dtype).to(self.x.device)

    def _draw_block(self, n_sweeps):
        """A block's normals (S, n, d) and uniforms (S, n), sweep by sweep
        (normals then uniforms), moved to the device together."""
        g, dt = self._generator, self.x.dtype
        eps = torch.empty((n_sweeps, self.n, self.dim), dtype=dt)
        u = torch.empty((n_sweeps, self.n), dtype=dt)
        for s in range(n_sweeps):
            eps[s] = torch.randn((self.n, self.dim), generator=g, dtype=dt)
            u[s] = torch.rand((self.n,), generator=g, dtype=dt)
        return eps.to(self.x.device), u.to(self.x.device)

    # ------------------------------------------------------------- init
    def particles_init(self, box, n, method="randunif"):
        """Uniform initialization in the box."""
        assert self.dim == len(box[0]), (
            "Box dimension does not match particles dimension"
        )
        self.n = n
        if method == "randunif":
            u = self.rng.uniform(size=(n, self.dim))
            self.x = gnp.asarray(qmc.scale(u, box[0], box[1]))
        else:
            raise NotImplementedError(
                f"The method '{method}' is not supported. Currently, only "
                f"'randunif' is available."
            )
        self.logpx = torch.zeros((n,), dtype=self.x.dtype, device=self.x.device)
        self.w_tmp = torch.full((n,), 1.0 / n, dtype=self.x.dtype, device=self.x.device)
        self.w = self.w_tmp.clone()

    def set_logpdf(self, logpdf_function):
        self.logpdf_function = logpdf_function

    def set_logpdf_with_parameter(self, logpdf_parameterized_function, param):
        def logpdf(x):
            return logpdf_parameterized_function(x, param)

        self.logpdf_function = logpdf

    def _logpdf(self, x):
        return gnp.asarray(self.logpdf_function(x)).reshape(-1)

    # ------------------------------------------------------------- weights
    def reweight(self, update_logpx_and_w=True):
        """w <- w * exp(logp_new - logp_old); optionally commit."""
        logpx_new = self._logpdf(self.x)
        self.w_tmp = self.w * torch.exp(logpx_new - self.logpx)
        if update_logpx_and_w:
            self.logpx = logpx_new
            self.w = self.w_tmp

    def ess(self):
        """Effective sample size (sum w)^2 / sum w^2 (one read)."""
        s, normalization = torch.stack(
            [torch.sum(self.w_tmp), torch.sum(self.w_tmp**2)]).tolist()
        if normalization == 0.0:
            return 0.0
        return s ** 2 / normalization

    # ------------------------------------------------------------- resample
    def _counts_to_indices(self, counts):
        return np.repeat(np.arange(self.n), counts)

    def _apply_resample_indices(self, idx):
        idx_t = torch.as_tensor(idx, device=self.x.device)
        self.x = self.x[idx_t]
        self.logpx = self.logpx[idx_t]
        self.w_tmp = torch.full((self.n,), 1.0 / self.n, dtype=self.x.dtype,
                                device=self.x.device)
        self.w = self.w_tmp.clone()

    def _normalized_p(self):
        w = _host(self.w_tmp)
        s = w.sum()
        if s == 0.0:
            return np.full(self.n, 1.0 / self.n)
        return w / s

    def resample(self, debug=False):
        if self.config.resample_scheme == "multinomial":
            self.multinomial_resample(debug=debug)
        elif self.config.resample_scheme == "residual":
            self.residual_resample(debug=debug)
        else:
            raise ValueError(
                "Unknown resample scheme: {}".format(self.config.resample_scheme)
            )

    def multinomial_resample(self, debug=False):
        p = self._normalized_p()
        counts = self.rng.multinomial(self.n, p)
        if debug:
            print(
                f"Multinomial resample: proportion discarded = "
                f"{(counts == 0).sum() / self.n} "
            )
        self._apply_resample_indices(self._counts_to_indices(counts))

    def residual_resample(self, debug=False):
        """Deterministic floor counts + multinomial on the residuals."""
        N = self.n
        p = self._normalized_p()
        counts_det = np.floor(N * p).astype(int)
        N_det = int(counts_det.sum())
        residuals = np.maximum(N * p - counts_det, 0.0)
        N_residual = N - N_det
        if N_residual > 0:
            total_residual = residuals.sum()
            p_vals = (
                residuals / total_residual
                if total_residual > 0
                else np.full_like(residuals, 1.0 / len(residuals))
            )
            counts_res = self.rng.multinomial(N_residual, p_vals)
        else:
            counts_res = np.zeros_like(counts_det)
        counts = counts_det + counts_res
        if debug:
            print(
                f"Residual resample: proportion discarded = "
                f"{(counts == 0).sum() / self.n} "
            )
        self._apply_resample_indices(self._counts_to_indices(counts))

    # ------------------------------------------------------------- moves
    def _proposal_chol(self):
        """Cholesky factor of param_s * Cov(x) on the host, with diagonal
        jitter escalation on covariance degeneracy (reference
        smc.py:357-417); the particles' covariance is one read."""
        lower = self.config.param_s_lower_bound
        upper = self.config.param_s_upper_bound
        if self.param_s > upper or self.param_s < lower:
            raise ParticlesSetError(self.param_s, lower, upper)
        if self.config.covariance_method == "knn":
            base_cov = knn_cov.estimate_cov_matrix_knn(
                self.x,
                n_random=self.config.covariance_knn_n_random,
                n_neighbors=self.config.covariance_knn_n_neighbors,
                rng=self.rng,
            )
        elif self.config.covariance_method == "normal":
            base_cov = knn_cov.estimate_cov_matrix(self.x)
        else:
            raise ValueError(
                f"Unknown covariance_method: {self.config.covariance_method}"
            )
        C = self.param_s * _host(base_cov).reshape(self.dim, self.dim)
        jitter = 0.0
        for _ in range(self.config.jitter_max_iterations + 1):
            C_try = C if jitter == 0.0 else C + jitter * np.eye(self.dim)
            L_try = (np.linalg.cholesky(C_try)
                     if np.all(np.isfinite(C_try)) else None)
            if L_try is not None and np.all(np.isfinite(L_try)):
                return gnp.asarray(L_try).to(self.x.dtype)
            jitter = (self.config.jitter_initial_value if jitter == 0.0
                      else 10.0 * jitter)
        raise RuntimeError(
            "Failed to generate samples after "
            f"{self.config.jitter_max_iterations} jittering attempts. "
            "Covariance matrix might still be non-PSD."
        )

    def perturb(self):
        """x + eps with eps ~ N(0, param_s * Cov(x))."""
        L = self._proposal_chol()
        return self.x + self._draw_normals((self.n, self.dim)) @ L.T

    def _accept(self, y, logpy, u):
        """Accept y where log u < logpy - logpx (u floored at 1e-300): the
        state is updated by torch.where; returns the accept mask."""
        accept = torch.log(torch.clamp_min(u, 1e-300)) < logpy - self.logpx
        self.x = torch.where(accept[:, None], y, self.x)
        self.logpx = torch.where(accept, logpy, self.logpx)
        return accept

    def move(self):
        """One vectorized MH sweep over all particles; returns the
        acceptance rate (one read)."""
        y = self.perturb()
        logpy = self._logpdf(y)
        accept = self._accept(y, logpy, self._draw_uniforms((self.n,)))
        return float(torch.sum(accept)) / self.n

    def move_block(self, n_sweeps):
        """n_sweeps vectorized MH sweeps with one proposal factor (the
        per-sweep refresh of move() is a tuning detail: each sweep is a valid
        MH kernel for the current target); the sweeps' draws are made
        together, the acceptance rates read once.  Returns the mean
        acceptance rate over the block."""
        if n_sweeps <= 0:
            return 0.0
        L = self._proposal_chol()
        eps, u = self._draw_block(n_sweeps)
        rates = []
        for s in range(n_sweeps):
            y = self.x + eps[s] @ L.T
            accept = self._accept(y, self._logpdf(y), u[s])
            rates.append(torch.mean(accept.to(self.x.dtype)))
        return float(torch.mean(torch.stack(rates)))


class SMC:
    """SMC driver (tempering with adaptive ladder and restarts)."""

    def __init__(self, box, n=2000, particles_config: ParticlesSetConfig = None,
                 smc_config: SMCConfig = None, rng=None):
        self.box = box
        self.n = n
        self.particles_config = (
            particles_config if particles_config is not None
            else ParticlesSetConfig()
        )
        self.smc_config = smc_config if smc_config is not None else SMCConfig()
        self.particles = ParticlesSet(box, n, config=self.particles_config,
                                      rng=rng)

        method = self.smc_config.compute_next_logpdf_param_method
        if method == "p0":
            self.compute_next_logpdf_param = self.compute_next_logpdf_param_p0
        elif method == "ess":
            self.compute_next_logpdf_param = self.compute_next_logpdf_param_ess
        else:
            raise ValueError(
                "compute_next_logpdf_param_method must be 'ess' or 'p0'."
            )

        self.log = []
        self.stage = 0
        self.log_data = {
            "current_logpdf_param": None,
            "ess": None,
            "target_logpdf_param": None,
            "restart_iteration": 0,
            "logpdf_param_sequence": [],
            "acceptation_rate_sequence": [],
            "execution_state": None,
        }

    # ------------------------------------------------------------- logging
    def update_log(self, logpdf_param=None, ess=None, acceptation_rate=None,
                   state=None):
        if logpdf_param is not None:
            self.log_data["current_logpdf_param"] = logpdf_param
        if ess is not None:
            self.log_data["ess"] = ess
        if acceptation_rate is not None:
            self.log_data["acceptation_rate_sequence"].append(acceptation_rate)
        if state is not None:
            self.log_data["execution_state"] = f"[Stage {self.stage}] {state}"

    def log_snapshot(self):
        snapshot = {
            "timestamp": time.time(),
            "stage": self.stage,
            "num_particles": self.n,
            "current_scaling_param": self.particles.param_s,
            "target_logpdf_param": self.log_data["target_logpdf_param"],
            "current_logpdf_param": self.log_data["current_logpdf_param"],
            "ess": self.log_data["ess"],
            "restart_iteration": self.log_data["restart_iteration"],
            "logpdf_param_sequence": self.log_data["logpdf_param_sequence"].copy(),
            "acceptation_rate_sequence":
                self.log_data["acceptation_rate_sequence"].copy(),
            "execution_state": self.log_data["execution_state"],
        }
        self.log.append(snapshot)
        self.log_data["acceptation_rate_sequence"] = []

    # ------------------------------------------------------------- stepping
    def step(self, logpdf_parameterized_function, logpdf_param, debug=False,
             debug_plot=False):
        """One SMC stage: set target -> reweight -> resample -> tuned move
        + (mh_steps - 1) extra sweeps."""
        self.update_log(state=f"Step start: set logpdf_param to {logpdf_param}")
        self.particles.set_logpdf_with_parameter(
            logpdf_parameterized_function, logpdf_param
        )
        self.update_log(state=f"Reweight with logpdf_param = {logpdf_param}")
        self.particles.reweight()
        ess_value = self.particles.ess()
        self.update_log(logpdf_param=logpdf_param, ess=ess_value)
        self.update_log(state=f"Resample particles (ESS = {ess_value})")
        self.particles.resample(debug)
        self.update_log(state="Move particles with controlled acceptation rate")
        if debug:
            print("Doing acceptation rate optimization...")
        self.move_with_controlled_acceptation_rate(debug)
        self.log_snapshot()
        if debug and self.smc_config.mh_steps > 1:
            print(
                f"Now doing additional MH steps "
                f"({self.smc_config.mh_steps - 1} moves)..."
            )
        n_extra = self.smc_config.mh_steps - 1
        if self.smc_config.blocked_moves and n_extra > 0:
            acceptation_rate = self.particles.move_block(n_extra)
            self.update_log(
                acceptation_rate=acceptation_rate,
                state=(
                    f"Additional moves x{n_extra} (scanned block) "
                    f"with mean acceptation rate {acceptation_rate:.2f}"
                ),
            )
        else:
            for i in range(n_extra):
                acceptation_rate = self.particles.move()
                self.update_log(
                    acceptation_rate=acceptation_rate,
                    state=(
                        f"Additional move {i + 1}/{n_extra} "
                        f"with acceptation rate {acceptation_rate:.2f}"
                    ),
                )
        self.log_snapshot()
        if debug_plot:
            self.plot_particles()

    def step_with_possible_restart(self, logpdf_parameterized_function,
                                   initial_logpdf_param, target_logpdf_param,
                                   min_ess_ratio, p0, debug=False):
        """Step toward target; restart with a tempering ladder when the ESS
        ratio collapses below min_ess_ratio."""
        self.stage += 1
        self.update_log(state="Starting step_with_possible_restart")
        self.log_data["current_logpdf_param"] = target_logpdf_param
        self.log_data["target_logpdf_param"] = target_logpdf_param
        self.log_snapshot()

        self.particles.set_logpdf_with_parameter(
            logpdf_parameterized_function, target_logpdf_param
        )
        self.update_log(state="Computing initial ESS in step_with_possible_restart")
        self.particles.reweight(update_logpx_and_w=False)
        ess_scalar = self.particles.ess()
        ess_ratio = ess_scalar / self.n
        self.update_log(ess=ess_scalar)

        if ess_ratio < min_ess_ratio:
            self.update_log(
                state=(
                    f"ESS ratio ({ess_ratio:.2f}) below threshold "
                    f"({min_ess_ratio}), initiating restart"
                )
            )
            self.log_snapshot()
            self.restart(
                logpdf_parameterized_function, initial_logpdf_param,
                target_logpdf_param, min_ess_ratio, p0, debug=debug,
            )
        else:
            self.update_log(
                state="ESS acceptable, proceeding with resampling and moves"
            )
            self.log_snapshot()
            self.step(logpdf_parameterized_function, target_logpdf_param)

    def restart(self, logpdf_parameterized_function, initial_logpdf_param,
                target_logpdf_param, min_ess_ratio, p0, debug=False):
        """Re-init particles and walk an adaptive tempering ladder from the
        initial to the target parameter (reference smc.py:742-827)."""
        if debug:
            print("---- (Re)starting SMC from initial parameter ----")
        self.update_log(state="Restarting: taking snapshot before restart")
        self.log_snapshot()

        if self.smc_config.compute_next_logpdf_param_method == "p0":
            threshold = p0
        else:
            threshold = min_ess_ratio

        self.update_log(state="Reinitializing particles with initial distribution")
        self.particles.particles_init(
            self.box, self.n,
            method=self.particles_config.initial_distribution_type,
        )

        self.particles.set_logpdf_with_parameter(
            logpdf_parameterized_function, initial_logpdf_param
        )
        self.particles.reweight(update_logpx_and_w=False)
        ess_ratio_init = self.particles.ess() / self.n
        if ess_ratio_init < min_ess_ratio:
            warnings.warn(
                f"ESS ratio {ess_ratio_init} below threshold={min_ess_ratio} "
                f"at initialization.",
                RuntimeWarning,
            )
            if self.smc_config.compute_next_logpdf_param_method == "ess":
                threshold = min(float(threshold), ess_ratio_init)

        current_logpdf_param = initial_logpdf_param
        self.log_data["logpdf_param_sequence"] = [initial_logpdf_param]
        self._run_ladder(
            logpdf_parameterized_function, current_logpdf_param,
            target_logpdf_param, threshold, debug=debug,
        )

    def _run_ladder(self, logpdf_parameterized_function, current_logpdf_param,
                    target_logpdf_param, threshold, debug=False):
        """Walk the adaptive tempering ladder from current to target;
        checkpoints after every stage when configured (resume re-enters
        here via resume_restart)."""
        self._ladder_state = {
            "current_logpdf_param": float(current_logpdf_param),
            "target_logpdf_param": float(target_logpdf_param),
            "threshold": float(threshold),
        }
        while current_logpdf_param != target_logpdf_param:
            next_logpdf_param = self.compute_next_logpdf_param(
                logpdf_parameterized_function, current_logpdf_param,
                target_logpdf_param, threshold, debug=debug,
            )
            if debug:
                print(
                    "Selected next tempering parameter (logpdf_param): "
                    f"{float(next_logpdf_param):.3e}"
                )
            self.log_data["restart_iteration"] += 1
            self.log_data["logpdf_param_sequence"].append(next_logpdf_param)
            self.update_log(
                state=(
                    f"Restart loop iteration "
                    f"{self.log_data['restart_iteration']}: stepping with "
                    f"logpdf_param {next_logpdf_param}"
                )
            )
            self.log_snapshot()
            self.step(logpdf_parameterized_function, next_logpdf_param,
                      debug=debug)
            current_logpdf_param = next_logpdf_param
            self._ladder_state["current_logpdf_param"] = float(
                current_logpdf_param
            )
            self._maybe_checkpoint()

        self._ladder_state = None
        self.log_data["logpdf_param_sequence"] = []
        self.log_data["restart_iteration"] = 0

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def _maybe_checkpoint(self):
        if self.smc_config.checkpoint_path is None:
            return
        self._stages_since_checkpoint = (
            getattr(self, "_stages_since_checkpoint", 0) + 1
        )
        if self._stages_since_checkpoint >= max(
            1, self.smc_config.checkpoint_every
        ):
            self.save_checkpoint(self.smc_config.checkpoint_path)
            self._stages_since_checkpoint = 0

    def get_state(self):
        """(arrays, meta) snapshot of particles + driver state; the
        generator's state is the uint8 array ``generator_state``."""
        p = self.particles
        arrays = {
            "x": gnp.to_np(p.x),
            "logpx": gnp.to_np(p.logpx),
            "w": gnp.to_np(p.w),
            "generator_state": p._generator.get_state().numpy().copy(),
        }
        meta = {
            "kind": "SMC",
            "n": self.n,
            "dim": p.dim,
            "param_s": float(p.param_s),
            "stage": int(self.stage),
            "rng_state": p.rng.bit_generator.state,
            "log": self.log,
            "log_data": {
                k: v for k, v in self.log_data.items()
                if k != "logpdf_param_sequence" or v is not None
            },
            "ladder_state": getattr(self, "_ladder_state", None),
        }
        return arrays, meta

    def set_state(self, arrays, meta):
        """Load a get_state() snapshot of this port (onto the configured
        device).  A gpmp_tpu state (its JAX ``key``, no generator state) is
        refused."""
        if meta.get("kind") != "SMC":
            raise ValueError(f"Not an SMC checkpoint: {meta.get('kind')!r}")
        if (meta["n"], meta["dim"]) != (self.n, self.particles.dim):
            raise ValueError(
                f"Checkpoint shape mismatch: ({self.n}, "
                f"{self.particles.dim}) vs ({meta['n']}, {meta['dim']})."
            )
        if "generator_state" not in arrays:
            raise ValueError(
                "state without a generator_state (a gpmp_tpu state holds a "
                "JAX key): the port's SMC cannot resume it"
            )
        p = self.particles
        p.x = gnp.asarray(np.array(arrays["x"], dtype=float))
        p.logpx = gnp.asarray(np.array(arrays["logpx"], dtype=float))
        p.w = gnp.asarray(np.array(arrays["w"], dtype=float))
        p._generator.set_state(
            torch.from_numpy(np.array(arrays["generator_state"], dtype=np.uint8)))
        p.param_s = meta["param_s"]
        p.rng.bit_generator.state = meta["rng_state"]
        self.stage = meta["stage"]
        self.log = list(meta["log"])
        self.log_data.update(meta["log_data"])
        self._ladder_state = meta.get("ladder_state")

    def save_checkpoint(self, path):
        from .checkpoint import save_sampler_checkpoint

        arrays, meta = self.get_state()
        save_sampler_checkpoint(path, arrays, meta)

    def restore_checkpoint(self, path):
        from .checkpoint import load_sampler_checkpoint

        arrays, meta = load_sampler_checkpoint(path)
        self.set_state(arrays, meta)

    def resume_restart(self, logpdf_parameterized_function, debug=False):
        """Continue an interrupted tempering ladder from restored state."""
        ls = getattr(self, "_ladder_state", None)
        if ls is None:
            raise ValueError(
                "No in-progress ladder in the restored state; nothing to "
                "resume."
            )
        self._run_ladder(
            logpdf_parameterized_function, ls["current_logpdf_param"],
            ls["target_logpdf_param"], ls["threshold"], debug=debug,
        )

    def move_with_controlled_acceptation_rate(self, debug=False):
        """Multiplicative param_s tuning to keep the MH acceptance rate in
        [rate_min, rate_max]."""
        self.update_log(state="Entering move_with_controlled_acceptation_rate")
        it = 0
        while it < self.smc_config.mh_adjustment_max_iterations:
            it += 1
            acceptation_rate = self.particles.move()
            self.update_log(
                acceptation_rate=acceptation_rate,
                state=(
                    f"Controlled move iteration {it} with acceptation rate "
                    f"{acceptation_rate:.2f}"
                ),
            )
            if debug:
                print(f"Acceptation rate = {acceptation_rate:.2f}")
            if acceptation_rate < self.smc_config.mh_acceptation_rate_min:
                self.particles.param_s /= self.smc_config.mh_adjustment_factor
                self.update_log(
                    state=(
                        f"Acceptation rate low ({acceptation_rate:.2f}); "
                        f"decreasing param_s to {self.particles.param_s:.2e}"
                    )
                )
                continue
            if acceptation_rate > self.smc_config.mh_acceptation_rate_max:
                self.particles.param_s *= self.smc_config.mh_adjustment_factor
                self.update_log(
                    state=(
                        f"Acceptation rate high ({acceptation_rate:.2f}); "
                        f"increasing param_s to {self.particles.param_s:.2e}"
                    )
                )
                continue
            break

    # --------------------------------------------- tempering ladder search
    def compute_next_logpdf_param_ess(self, logpdf_parameterized_function,
                                      current_logpdf_param, target_logpdf_param,
                                      eta0, debug=False):
        """Next ladder rung by brentq on ESS ratio - eta0."""
        tolerance = 0.05
        eta0 = float(eta0)
        current_logpdf_param = float(current_logpdf_param)
        target_logpdf_param = float(target_logpdf_param)

        def compute_delta_eta(logpdf_param):
            self.particles.set_logpdf_with_parameter(
                logpdf_parameterized_function, float(logpdf_param)
            )
            self.particles.reweight(update_logpx_and_w=False)
            eta = self.particles.ess() / self.particles.n
            if debug:
                print(
                    f"Search: eta = {eta:.2f} / eta0 = {eta0:.2f}, "
                    f"test logpdf_param = {float(logpdf_param):.3e}, "
                    f"current = {current_logpdf_param:.3e}, "
                    f"target = {target_logpdf_param:.3e}"
                )
            return eta - eta0

        f_target = compute_delta_eta(target_logpdf_param)
        if f_target > 0:
            if debug:
                print(
                    f"Target logpdf_param reached, current = "
                    f"{target_logpdf_param}."
                )
            return target_logpdf_param
        low = min(current_logpdf_param, target_logpdf_param)
        high = max(current_logpdf_param, target_logpdf_param)
        f_low = compute_delta_eta(low)
        f_high = compute_delta_eta(high)
        if f_low * f_high > 0:
            warnings.warn(
                "ESS threshold unattainable in current bracket; "
                "proceeding to target_logpdf_param.",
                RuntimeWarning,
            )
            return target_logpdf_param
        return brentq(compute_delta_eta, low, high, xtol=tolerance)

    def compute_p_value(self, logpdf_function, new_logpdf_param,
                        current_logpdf_param):
        """mean exp(logpdf(x, new) - logpdf(x, current)) over particles."""
        x = self.particles.x
        new = gnp.asarray(logpdf_function(x, new_logpdf_param)).reshape(-1)
        cur = gnp.asarray(logpdf_function(x, current_logpdf_param)).reshape(-1)
        return float(torch.mean(torch.exp(new - cur)))

    def compute_next_logpdf_param_p0(self, logpdf_parameterized_function,
                                     current_logpdf_param, target_logpdf_param,
                                     p0, debug=False):
        """Next ladder rung by dichotomy on the migration probability p0."""
        tolerance = 0.05
        low = current_logpdf_param
        high = target_logpdf_param
        p_target = self.compute_p_value(
            logpdf_parameterized_function, target_logpdf_param,
            current_logpdf_param,
        )
        if p_target >= p0:
            if debug:
                print("Target logpdf_param reached.")
            return target_logpdf_param
        while True:
            mid = (high + low) / 2
            p = self.compute_p_value(
                logpdf_parameterized_function, mid, current_logpdf_param
            )
            if debug:
                print(
                    f"Search: p = {p:.2f} / p0 = {p0:.2f}, "
                    f"test logpdf_param = {mid}, "
                    f"current = {current_logpdf_param}, "
                    f"target = {target_logpdf_param}"
                )
            if abs(p - p0) < tolerance:
                break
            if p < p0:
                high = mid
            else:
                low = mid
        return mid

    # ------------------------------------------------------------- plots
    def plot_state(self):
        """Stairs plots of tempering parameters, ESS, acceptance rates."""
        import matplotlib.pyplot as plt

        ess = [s["ess"] if s["ess"] is not None else np.nan for s in self.log]
        params = [
            s["current_logpdf_param"]
            if s["current_logpdf_param"] is not None
            else np.nan
            for s in self.log
        ]
        rates = []
        for s in self.log:
            rates.extend(s["acceptation_rate_sequence"])
        fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=False)
        axes[0].step(range(len(params)), params, where="post")
        axes[0].set_ylabel("logpdf param")
        axes[1].step(range(len(ess)), ess, where="post")
        axes[1].set_ylabel("ESS")
        axes[2].plot(rates, "o-", markersize=3)
        axes[2].set_ylabel("acc. rate")
        axes[2].set_xlabel("move")
        plt.tight_layout()
        plt.show()
        return fig

    def plot_particles(self):
        """Matrix plot of the particle cloud."""
        import matplotlib.pyplot as plt

        x = _host(self.particles.x)
        d = x.shape[1]
        fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d))
        if d == 1:
            axes = np.array([[axes]])
        for i in range(d):
            for j in range(d):
                ax = axes[i, j]
                if i == j:
                    ax.hist(x[:, i], bins=40, density=True, alpha=0.7)
                else:
                    ax.plot(x[:, j], x[:, i], ".", markersize=1, alpha=0.4)
        plt.tight_layout()
        plt.show()
        return fig

    def plot_empirical_distributions(self, parameter_indices=None,
                                     parameter_indices_pooled=None, bins=50):
        """Histograms of particle marginals."""
        import matplotlib.pyplot as plt

        x = _host(self.particles.x)
        dim = x.shape[1]
        if parameter_indices is None:
            parameter_indices = list(range(dim))
        n = len(parameter_indices)
        fig, axes = plt.subplots(n, 1, figsize=(8, min(9, 2.5 * n)))
        if n == 1:
            axes = [axes]
        for k, p in enumerate(parameter_indices):
            axes[k].hist(x[:, p], bins=bins, density=True, alpha=0.7)
            axes[k].set_ylabel(f"param {p}")
        plt.tight_layout()
        plt.show()
        return fig


def run_smc_sampling(
    logpdf_parameterized_function,
    initial_logpdf_param,
    target_logpdf_param,
    compute_next_logpdf_param_method,
    min_ess_ratio,
    p0=None,
    init_box=None,
    n_particles=1000,
    mh_steps=20,
    smc_config: SMCConfig = None,
    particles_config: ParticlesSetConfig = None,
    debug=False,
    plot_particles=False,
    plot_empirical_distributions=False,
    rng=None,
):
    """Full SMC run: one step_with_possible_restart toward the target.

    Returns (particles, smc), the particles a tensor on the configured
    device.
    """
    if particles_config is None:
        particles_config = ParticlesSetConfig(
            resample_scheme="residual", covariance_method="normal"
        )
    if smc_config is None:
        smc_config = SMCConfig(
            compute_next_logpdf_param_method=compute_next_logpdf_param_method,
            mh_steps=mh_steps,
        )
    smc = SMC(box=init_box, n=n_particles, particles_config=particles_config,
              smc_config=smc_config, rng=rng)
    smc.step_with_possible_restart(
        logpdf_parameterized_function, initial_logpdf_param,
        target_logpdf_param, min_ess_ratio, p0, debug=debug,
    )
    if plot_particles:
        try:
            smc.plot_particles()
        except Exception as e:
            print("Plotting failed:", e)
    if plot_empirical_distributions:
        try:
            smc.plot_empirical_distributions()
        except Exception as e:
            print("Plotting failed:", e)
    return smc.particles.x, smc


def log_indicator_density(f, threshold, log_px, tail="lower"):
    """logpdf(x) = log(1_{f(x) ? threshold} p_X(x)) with ? = < or >."""

    def logpdf(x):
        x = gnp.asarray(x)
        fx = gnp.asarray(f(x)).reshape(-1)
        logpx = gnp.asarray(log_px(x)).reshape(-1)
        if tail == "lower":
            return torch.where(fx < threshold, logpx, -1e100)
        elif tail == "upper":
            return torch.where(fx > threshold, logpx, -1e100)
        raise ValueError(f"Invalid tail argument: {tail}")

    return logpdf


def run_subset_simulation(
    f,
    thresholds,
    init_box,
    log_px,
    tail="upper",
    n_particles=1000,
    mh_steps=20,
    min_acceptation=0.15,
    max_acceptation=0.30,
    resample_scheme="residual",
    debug=False,
    rng=None,
):
    """Subset simulation: P(f(X) ? u_T) = prod of stage conditional
    probabilities over a threshold ladder (reference smc.py:1362-1468).

    Returns (p_estimate, stage_probs, smc).
    """
    if tail == "lower":
        assert thresholds[0] == float("inf"), (
            "First threshold must be +inf for tail='lower'."
        )
    elif tail == "upper":
        assert thresholds[0] == float("-inf"), (
            "First threshold must be -inf for tail='upper'."
        )
    else:
        raise ValueError(f"Invalid tail: {tail}")

    particles_config = ParticlesSetConfig(
        initial_distribution_type="randunif", resample_scheme=resample_scheme
    )
    smc_config = SMCConfig(
        compute_next_logpdf_param_method="p0",
        mh_steps=mh_steps,
        mh_acceptation_rate_min=min_acceptation,
        mh_acceptation_rate_max=max_acceptation,
    )
    smc = SMC(init_box, n=n_particles, particles_config=particles_config,
              smc_config=smc_config, rng=rng)

    smc.particles.particles_init(init_box, n_particles)
    smc.log_data["target_logpdf_param"] = thresholds[1]

    stage_probs = np.empty(len(thresholds) - 1)

    for k in range(1, len(thresholds)):
        uk = thresholds[k]
        if debug:
            print(f"\n[Stage {k}] Threshold u_k = {uk:.2f}")
        logpdf_k = log_indicator_density(f, uk, log_px, tail=tail)
        smc.particles.set_logpdf(logpdf_k)
        smc.particles.reweight()
        w_sum = float(torch.sum(smc.particles.w))
        stage_probs[k - 1] = w_sum
        if debug:
            print(f"    p_stage = {w_sum:.4f}")
        smc.particles.w = smc.particles.w / w_sum
        smc.particles.w_tmp = smc.particles.w
        smc.particles.resample(debug=debug)
        smc.move_with_controlled_acceptation_rate(debug=debug)
        for _ in range(mh_steps - 1):
            smc.particles.move()
        smc.stage += 1
        smc.log_snapshot()

    p_estimate = float(np.prod(stage_probs))
    return p_estimate, stage_probs, smc
