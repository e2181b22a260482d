# gpmp_tpu_torch/mcmc/nuts.py
"""No-U-Turn Sampler (Euclidean metric, diagonal mass), counterpart of
gpmp_tpu/mcmc/nuts.py.

Leapfrog integrator, slice variable log_u = -H0 + log(rand), doubling tree
with progressive per-leaf proposal selection, divergence flag DeltaH >
delta_max, velocity-based U-turn test, dual-averaging step-size adaptation
with Stan-like windowed diagonal mass adaptation (Welford) and
dual-averaging restarts at window ends.

Design:
- The tree is the JAX package's iterative one (gpmp_tpu/mcmc/nuts.py:
  343-550): subtrees grow leaf by leaf with a checkpoint stack of even-leaf
  states, so the U-turn checks probe the same subtree boundaries and the
  trees are the JAX package's.  Its ``lax.while_loop``s become a host loop:
  the states, the leapfrog and the U-turn sums stay on the device, and each
  leaf reads back one small tensor (its energy and its U-turn flag); each
  completed doubling reads back the whole trajectory's U-turn flag.
- The log-probability's gradient is ``torch.autograd.grad``; one
  value+grad per leaf, chain after chain (the port's gram kernels have no
  batching rule, so there is no vmap).
- Random numbers come from one ``torch.Generator`` on the CPU, seeded from
  the options' ``seed``.  A transition takes its draws from a draw source,
  called for the momentum, the slice variable, each doubling's direction
  and adopt draw, and each leaf's adopt draw: the order of the JAX
  package's key splits (:353, :401, :498).  One seed gives the same draws
  on the card and on the CPU; a checkpoint holds the generator's state.
- The JAX package's dispatch options (``scan_sampling``, ``scan_warmup``,
  ``fused``, ``vmap_chains``) choose among its device programs; here there
  is one host loop and they change nothing.
"""

import math
import time
from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np
import torch

import gpmp_tpu_torch.num as gnp

from .mh import _new_generator, check_chain_mesh

_DEFAULT_NUM_WARMUP = 1000
_DEFAULT_TARGET_ACCEPT = 0.80
_DEFAULT_MAX_DEPTH = 10
_DEFAULT_DELTA_MAX = 1000.0
_DEFAULT_JITTER = 1e-4
_DEFAULT_PROGRESS = True
_DEFAULT_VERBOSE = 1
_DEFAULT_LOG_EVERY = 50


@dataclass
class NUTSOptions:
    """Configuration for NUTS sampling and warmup adaptation.

    Every field of the JAX package's NUTSOptions is kept.  ``mesh`` is None
    or a one-device mesh of ``parallel.make_mesh``.  ``scan_sampling``,
    ``scan_sampling_threshold``, ``scan_warmup``, ``scan_warmup_threshold``,
    ``scan_warmup_chunk``, ``fused`` and ``vmap_chains`` select the JAX
    package's device programs (scanned, fused, vmapped or sequential
    chains); the port runs one host loop, chain after chain, and ignores
    them: they change neither the draws nor the trajectories.  With
    ``checkpoint_path`` set, the sampling phase (after warmup) writes the
    full state every ``checkpoint_every`` steps; resume with
    ``nuts_resume``.
    """

    num_warmup: int = _DEFAULT_NUM_WARMUP
    target_accept: float = _DEFAULT_TARGET_ACCEPT
    max_depth: int = _DEFAULT_MAX_DEPTH
    delta_max: float = _DEFAULT_DELTA_MAX
    jitter: float = _DEFAULT_JITTER
    init_step_size: Optional[float] = None
    init_mass_diag: Optional[np.ndarray] = None
    seed: Optional[int] = None
    progress: bool = _DEFAULT_PROGRESS
    verbose: int = _DEFAULT_VERBOSE
    log_every: int = _DEFAULT_LOG_EVERY

    mesh: Optional[Any] = None
    mesh_axis_name: str = "chains"
    scan_sampling: Optional[bool] = None
    scan_sampling_threshold: int = 200
    scan_warmup: Optional[bool] = None
    scan_warmup_threshold: int = 300
    scan_warmup_chunk: int = 200
    fused: Optional[bool] = None

    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 200
    vmap_chains: bool = True

    # dual averaging
    dual_averaging_gamma: float = 0.05
    dual_averaging_t0: float = 10.0
    dual_averaging_kappa: float = 0.75
    dual_averaging_mu_factor: float = 10.0

    # warmup window policy
    warmup_min_no_window: int = 20
    warmup_large_threshold: int = 150
    warmup_large_init_buffer: int = 75
    warmup_large_term_buffer: int = 50
    warmup_large_base_window: int = 25
    warmup_init_buffer_ratio: float = 0.15
    warmup_term_buffer_ratio: float = 0.10
    warmup_base_window_divisor: float = 3.0

    # initial step-size search
    find_eps_init: float = 1.0
    find_eps_target_accept: float = 0.5
    find_eps_scale_base: float = 2.0
    find_eps_min: float = 1e-6
    find_eps_max: float = 1e2


def _resolve_nuts_options(options, *, num_warmup, target_accept, max_depth,
                          delta_max, jitter, init_step_size, init_mass_diag,
                          seed, progress, verbose, log_every):
    """Merge rule: explicit non-default kwargs override the options object."""
    opts = replace(options) if options is not None else NUTSOptions()
    if options is None or num_warmup != _DEFAULT_NUM_WARMUP:
        opts.num_warmup = num_warmup
    if options is None or target_accept != _DEFAULT_TARGET_ACCEPT:
        opts.target_accept = target_accept
    if options is None or max_depth != _DEFAULT_MAX_DEPTH:
        opts.max_depth = max_depth
    if options is None or delta_max != _DEFAULT_DELTA_MAX:
        opts.delta_max = delta_max
    if options is None or jitter != _DEFAULT_JITTER:
        opts.jitter = jitter
    if options is None or init_step_size is not None:
        opts.init_step_size = init_step_size
    if options is None or init_mass_diag is not None:
        opts.init_mass_diag = init_mass_diag
    if options is None or seed is not None:
        opts.seed = seed
    if options is None or progress != _DEFAULT_PROGRESS:
        opts.progress = progress
    if options is None or verbose != _DEFAULT_VERBOSE:
        opts.verbose = verbose
    if options is None or log_every != _DEFAULT_LOG_EVERY:
        opts.log_every = log_every
    return opts


class SimpleLogger:
    def __init__(self, verbose=1):
        self.verbose = int(verbose)

    def log(self, msg, level=1):
        if self.verbose >= level:
            print(msg, flush=True)


# ---------------------------
# Adaptation utilities (host-side)
# ---------------------------
@dataclass
class DualAveragingState:
    mu: float
    log_eps: float
    log_eps_bar: float
    h_bar: float
    t: int

    def update(self, accept_stat, target=0.80, gamma=0.05, t0=10.0, kappa=0.75):
        self.t += 1
        eta = 1.0 / (self.t + t0)
        self.h_bar = (1.0 - eta) * self.h_bar + eta * (target - accept_stat)
        self.log_eps = self.mu - (math.sqrt(self.t) / gamma) * self.h_bar
        w = self.t ** (-kappa)
        self.log_eps_bar = w * self.log_eps + (1.0 - w) * self.log_eps_bar
        return math.exp(self.log_eps)

    def final(self):
        return math.exp(self.log_eps_bar)


class RunningDiagVar:
    """Welford online variance (vectorized over a batch of chains)."""

    def __init__(self, dim):
        self.n = 0
        self.mean = np.zeros(dim)
        self.m2 = np.zeros(dim)

    def update_one(self, x):
        self.n += 1
        delta = x - self.mean
        self.mean = self.mean + delta / self.n
        self.m2 = self.m2 + delta * (x - self.mean)

    def update_batch(self, x):
        for i in range(x.shape[0]):
            self.update_one(np.asarray(x[i]))

    def var(self):
        if self.n < 2:
            return np.ones_like(self.mean)
        return self.m2 / (self.n - 1)


def make_warmup_windows(num_warmup, *, min_no_window=20, large_threshold=150,
                        large_init_buffer=75, large_term_buffer=50,
                        large_base_window=25, init_buffer_ratio=0.15,
                        term_buffer_ratio=0.10, base_window_divisor=3.0):
    """Stan-like expanding windows for diagonal mass adaptation."""
    if num_warmup <= min_no_window:
        return []
    if num_warmup >= large_threshold:
        init_buffer = large_init_buffer
        term_buffer = large_term_buffer
        base_window = large_base_window
    else:
        init_buffer = max(1, int(init_buffer_ratio * num_warmup))
        term_buffer = max(1, int(term_buffer_ratio * num_warmup))
        base_window = max(
            1, int((num_warmup - init_buffer - term_buffer) / base_window_divisor)
        )
    start = init_buffer
    end_middle = num_warmup - term_buffer
    if end_middle <= start:
        return []
    win = min(base_window, end_middle - start)
    windows = []
    while start + win < end_middle:
        windows.append((start, start + win))
        start += win
        win = min(2 * win, end_middle - start)
        if win <= 0:
            break
    if start < end_middle:
        windows.append((start, end_middle))
    return windows


def describe_windows(windows):
    if not windows:
        return "no mass adaptation windows"
    return "mass windows: " + " ".join(f"[{a},{b})" for a, b in windows)


# ---------------------------
# Hamiltonian pieces
# ---------------------------
def potential_and_grad(log_prob, q, *, use_helper=True):
    """(U(q), gradU(q)) with U = -log_prob, via torch.autograd.grad; both
    detached, on q's device.  A log_prob with its own
    ``potential_and_grad`` (param_posterior's, which replays a CUDA graph on
    the card) computes them itself."""
    own = getattr(log_prob, "potential_and_grad", None)
    if own is not None:
        return own(q)
    with torch.enable_grad():
        qq = gnp.asarray(q).detach().requires_grad_(True)
        U = -gnp.asarray(log_prob(qq)).reshape(())
        if U.requires_grad:
            (g,) = torch.autograd.grad(U, qq, allow_unused=True)
        else:
            g = None
    if g is None:
        g = torch.zeros_like(qq)
    return U.detach(), g


def kinetic(p, inv_mass_diag):
    return 0.5 * torch.sum(p * p * inv_mass_diag)


def leapfrog(log_prob, q, p, gradU, eps, inv_mass_diag):
    """One leapfrog step with step size eps."""
    p_half = p - 0.5 * eps * gradU
    q_new = q + eps * (p_half * inv_mass_diag)
    U_new, g_new = potential_and_grad(log_prob, q_new)
    p_new = p_half - 0.5 * eps * g_new
    return q_new, p_new, U_new, g_new


def is_uturn(q_minus, q_plus, p_minus, p_plus, inv_mass_diag):
    """Velocity-based U-turn test (correct for diagonal M != I); a 0-d bool
    tensor."""
    dq = q_plus - q_minus
    v_minus = inv_mass_diag * p_minus
    v_plus = inv_mass_diag * p_plus
    return (torch.sum(dq * v_minus) < 0.0) | (torch.sum(dq * v_plus) < 0.0)


def _find_reasonable_step_size_from(log_prob, q, inv_mass_diag, p0, init_eps=1.0,
                                    target_accept=0.5, scale_base=2.0, min_eps=1e-6,
                                    max_eps=1e2, max_iters=None):
    """find_reasonable_step_size from a given momentum p0."""
    eps = float(init_eps)
    U0, g0 = potential_and_grad(log_prob, q)
    H0 = U0 + kinetic(p0, inv_mass_diag)

    def alpha_at(eps_):
        _q1, p1, U1, _g1 = leapfrog(log_prob, q, p0, g0, eps_, inv_mass_diag)
        la = float(-((U1 + kinetic(p1, inv_mass_diag)) - H0))
        return math.exp(min(la, 0.0)) if math.isfinite(la) else 0.0

    if max_iters is None:
        span = max(max_eps / max(min_eps, 1e-300), 2.0)
        max_iters = int(math.log(span) / math.log(max(scale_base, 1.001))) + 4

    alpha = alpha_at(eps)
    direction = 1.0 if alpha > target_accept else -1.0
    for _ in range(max_iters):
        eps *= scale_base**direction
        alpha2 = alpha_at(eps)
        if (alpha2 > target_accept and direction < 0) or (
            alpha2 < target_accept and direction > 0
        ):
            break
        if eps < min_eps or eps > max_eps:
            break
    return float(eps)


def find_reasonable_step_size(log_prob, q, inv_mass_diag, init_eps=1.0,
                              target_accept=0.5, scale_base=2.0, min_eps=1e-6,
                              max_eps=1e2, generator=None, max_iters=None):
    """Doubling/halving search for an initial step size.

    Returns the first step size past the target acceptance, as the JAX
    package does.  ``generator`` (a torch.Generator; the module-level one
    of ``gnp`` when None) draws the momentum.  ``max_iters`` bounds the
    loop on top of the [min_eps, max_eps] range; None derives it from that
    range (+4 slack).
    """
    q = gnp.asarray(q)
    inv_mass_diag = gnp.asarray(inv_mass_diag)
    gen = gnp._generator(generator)
    z = torch.randn(tuple(q.shape), generator=gen, dtype=q.dtype, device=gen.device)
    p0 = z.to(q.device) * torch.sqrt(1.0 / inv_mass_diag)
    return _find_reasonable_step_size_from(
        log_prob, q, inv_mass_diag, p0, init_eps=init_eps, target_accept=target_accept,
        scale_base=scale_base, min_eps=min_eps, max_eps=max_eps, max_iters=max_iters)


# ---------------------------
# The transition: iterative tree, host-driven
# ---------------------------
def _popcount(i):
    return bin(i).count("1")


def _ctz(x):
    """Count trailing zeros of a positive int."""
    return (x & -x).bit_length() - 1


class _GeneratorDraws:
    """A transition's draw source on a CPU torch.Generator: ``"momentum"``
    gives dim standard normals (a CPU tensor), any other kind one uniform
    (a Python float)."""

    def __init__(self, generator, dim, dtype):
        self.generator, self.dim, self.dtype = generator, dim, dtype

    def __call__(self, kind):
        if kind == "momentum":
            return torch.randn((self.dim,), generator=self.generator, dtype=self.dtype)
        return float(torch.rand((), generator=self.generator, dtype=self.dtype))


def _make_transition(log_prob, max_depth):
    """The NUTS transition for a fixed max_depth.

    transition(draws, q0, step_size, inv_mass_diag, delta_max) ->
      (q_new, accept_stat, n_leapfrog, depth, divergent, U_new)
    with q_new a tensor on q0's device, U_new (the potential at q_new) a
    0-d tensor there, and the others host scalars.  ``draws(kind)`` is
    called for "momentum", "slice", then per doubling "direction", each
    leaf's "leaf", and the doubling's "adopt".
    """
    max_depth = int(max_depth)

    def pg(q):
        return potential_and_grad(log_prob, q)

    def transition(draws, q0, step_size, inv_mass_diag, delta_max):
        step_size = float(step_size)
        delta_max = float(delta_max)
        inv_mass_diag = gnp.asarray(inv_mass_diag)
        mass_diag = 1.0 / inv_mass_diag
        p0 = draws("momentum").to(device=q0.device, dtype=q0.dtype) * torch.sqrt(mass_diag)
        U0, g0 = pg(q0)
        H0 = float(U0 + kinetic(p0, inv_mass_diag))
        bad_H0 = not math.isfinite(H0)
        log_u = -H0 + math.log(max(draws("slice"), 1e-300))

        def build_subtree(edge, v, depth):
            """Iteratively add 2^depth leaves from ``edge`` in direction v.

            Returns (edge_end, q_prop, U_prop, n_valid, alpha_sum, n_alpha,
            n_leapfrog, completed, divergent); q_prop is None when no leaf
            is valid (the JAX package keeps the edge there, which the
            doubling then never adopts: its adopt probability is 0).
            """
            num_leaves = 1 << depth
            q, p, g = edge
            q_prop = U_prop = None
            n_valid, alpha_sum, n_alpha = 0, 0.0, 0
            turning = divergent = stop = False
            stack_q = [None] * (max_depth + 1)
            stack_p = [None] * (max_depth + 1)
            eps = step_size * v
            i = 0
            while i < num_leaves and not stop:
                u_adopt = draws("leaf")
                q, p, U1, g = leapfrog(log_prob, q, p, g, eps, inv_mass_diag)
                H1_t = U1 + kinetic(p, inv_mass_diag)
                even = i % 2 == 0
                if even:
                    slot = _popcount(i)
                    stack_q[slot], stack_p[slot] = q, p
                    H1, turn = float(H1_t), False
                else:
                    # U-turn checks for every complete subtree ending at i
                    # (generation order: the stored state is the subtree's
                    # first, q its last; for v = -1 the recursion's
                    # endpoints swap, which folds v into dq)
                    vp = inv_mass_diag * p
                    flags = []
                    for j in range(1, min(_ctz(i + 1), max_depth) + 1):
                        sl = _popcount(i + 1 - (1 << j))
                        dqg = v * (q - stack_q[sl])
                        flags.append(torch.sum(dqg * (inv_mass_diag * stack_p[sl])))
                        flags.append(torch.sum(dqg * vp))
                    vals = torch.stack([H1_t] + flags).tolist()
                    H1, turn = vals[0], any(s < 0.0 for s in vals[1:])
                bad = not math.isfinite(H1)
                valid = (not bad) and (log_u <= -H1)
                divergent_leaf = bad or (H1 - H0) > delta_max
                stop_leaf = divergent_leaf or (log_u >= (delta_max - H1))
                alpha = 0.0 if bad else math.exp(min(-(H1 - H0), 0.0))
                n_new = n_valid + int(valid)
                adopt_p = 1.0 / max(n_new, 1) if valid else 0.0
                if u_adopt < adopt_p:
                    q_prop, U_prop = q, U1
                n_valid = n_new
                alpha_sum += alpha
                n_alpha += 1
                turning = turning or turn
                divergent = divergent or divergent_leaf
                stop = stop_leaf or turning
                i += 1
            completed = (i == num_leaves) and not turning and not divergent
            return ((q, p, g), q_prop, U_prop, n_valid, alpha_sum, n_alpha, i,
                    completed, divergent)

        q_minus = q_plus = q0
        p_minus = p_plus = p0
        g_minus = g_plus = g0
        q_prop, U_prop = q0, U0
        n_valid, depth = 1, 0
        s_cont = not bad_H0
        alpha_sum, n_alpha, n_leapfrog = 0.0, 0, 0
        divergent = bad_H0
        while s_cont and depth < max_depth:
            go_left = draws("direction") < 0.5
            v = -1.0 if go_left else 1.0
            edge = (q_minus, p_minus, g_minus) if go_left else (q_plus, p_plus, g_plus)
            (edge_end, q_prop2, U_prop2, n_valid2, alpha2, n_alpha2, nlf2, completed,
             div2) = build_subtree(edge, v, depth)
            if go_left:
                q_minus, p_minus, g_minus = edge_end
            else:
                q_plus, p_plus, g_plus = edge_end
            total = n_valid + n_valid2
            adopt_p = n_valid2 / max(total, 1) if (completed and total > 0) else 0.0
            if draws("adopt") < adopt_p:
                q_prop, U_prop = q_prop2, U_prop2
            s_cont = completed and not bool(
                is_uturn(q_minus, q_plus, p_minus, p_plus, inv_mass_diag))
            depth += 1
            n_valid = total
            alpha_sum += alpha2
            n_alpha += n_alpha2
            n_leapfrog += nlf2
            divergent = divergent or div2
        accept_stat = alpha_sum / max(n_alpha, 1)
        return q_prop, accept_stat, n_leapfrog, depth, divergent, U_prop

    return transition


def nuts_transition(log_prob, q0, step_size, inv_mass_diag, max_depth,
                    delta_max, generator=None):
    """Single-chain NUTS transition.  ``generator``: a CPU torch.Generator
    (a freshly seeded one when None).  Returns (q_new, accept_stat,
    n_leapfrog, depth, divergent)."""
    if generator is None:
        generator = _new_generator(None)
    q0 = gnp.asarray(q0)
    trans = _make_transition(log_prob, int(max_depth))
    q_new, a, nlf, depth, div, _U = trans(
        _GeneratorDraws(generator, q0.shape[0], q0.dtype), q0, step_size,
        gnp.asarray(inv_mass_diag), delta_max,
    )
    return q_new, float(a), int(nlf), int(depth), bool(div)


# ---------------------------
# Sampling loop
# ---------------------------
def _step_chains(transition, draws, q, step_size, inv_mass_diag, delta_max):
    """One transition per chain, chain after chain: (q_new (C, d) on the
    device, then host arrays accept, n_leapfrog, depth, divergent and the
    log-probability at q_new)."""
    outs = [transition(draws, q[c], step_size, inv_mass_diag, delta_max)
            for c in range(q.shape[0])]
    q_new = torch.stack([o[0] for o in outs])
    lp = -torch.stack([o[5] for o in outs])
    return (q_new, np.array([o[1] for o in outs]), np.array([o[2] for o in outs]),
            np.array([o[3] for o in outs]), np.array([o[4] for o in outs]), lp)


def nuts_sample(log_prob, q_init, num_samples,
                num_warmup=_DEFAULT_NUM_WARMUP,
                target_accept=_DEFAULT_TARGET_ACCEPT,
                max_depth=_DEFAULT_MAX_DEPTH,
                delta_max=_DEFAULT_DELTA_MAX,
                jitter=_DEFAULT_JITTER,
                init_step_size=None, init_mass_diag=None, seed=None,
                progress=_DEFAULT_PROGRESS, verbose=_DEFAULT_VERBOSE,
                log_every=_DEFAULT_LOG_EVERY,
                options: Optional[NUTSOptions] = None):
    """NUTS with warmup; q_init (chains, dim); returns
    (samples (num_samples, chains, dim), info dict of traces).

    ``log_prob(q)`` takes one chain's state, a tensor of shape (dim,) on the
    configured device, and returns a differentiable scalar tensor."""
    q_init = gnp.asarray(q_init)
    if q_init.ndim != 2:
        raise ValueError("q_init must have shape (chains, dim)")

    opts = _resolve_nuts_options(
        options, num_warmup=num_warmup, target_accept=target_accept,
        max_depth=max_depth, delta_max=delta_max, jitter=jitter,
        init_step_size=init_step_size, init_mass_diag=init_mass_diag,
        seed=seed, progress=progress, verbose=verbose, log_every=log_every,
    )
    check_chain_mesh(opts.mesh)
    num_warmup = int(opts.num_warmup)
    target_accept = float(opts.target_accept)
    max_depth = int(opts.max_depth)
    delta_max = float(opts.delta_max)
    jitter = float(opts.jitter)
    logger = SimpleLogger(verbose=int(opts.verbose))
    log_every = int(opts.log_every)

    chains, dim = q_init.shape
    eps_min = float(opts.find_eps_min)
    eps_max = float(opts.find_eps_max)
    if not math.isfinite(eps_min) or eps_min <= 0.0:
        eps_min = 1e-12
    if not math.isfinite(eps_max) or eps_max <= eps_min:
        eps_max = max(1.0, 10.0 * eps_min)

    def _clamp(eps):
        eps = float(eps)
        if not math.isfinite(eps) or eps <= 0.0:
            return eps_min
        return min(max(eps, eps_min), eps_max)

    logger.log(f"chains={chains}, dim={dim}")
    logger.log(f"num_warmup={num_warmup}, num_samples={num_samples}")
    logger.log(
        f"target_accept={target_accept}, max_depth={max_depth}, "
        f"delta_max={delta_max}"
    )

    generator = _new_generator(opts.seed)
    if opts.seed is not None:
        logger.log(f"seed={opts.seed}")
    draws = _GeneratorDraws(generator, dim, q_init.dtype)

    if opts.init_mass_diag is None:
        mass_diag = np.ones(dim)
        logger.log("mass_diag init: identity (ones)")
    else:
        imd = np.asarray(gnp.to_np(opts.init_mass_diag), dtype=float)
        if imd.shape != (dim,):
            raise ValueError("init_mass_diag must have shape (dim,)")
        mass_diag = np.clip(imd, jitter, None)
        logger.log("mass_diag init: provided (clamped)")
    inv_mass_diag = 1.0 / mass_diag

    transition = _make_transition(log_prob, max_depth)

    if opts.init_step_size is None:
        t0 = time.time()
        eps0 = find_reasonable_step_size(
            log_prob, q_init[0], gnp.asarray(inv_mass_diag),
            init_eps=opts.find_eps_init,
            target_accept=opts.find_eps_target_accept,
            scale_base=opts.find_eps_scale_base,
            min_eps=opts.find_eps_min, max_eps=opts.find_eps_max, generator=generator,
        )
        logger.log(
            f"initial step size heuristic: eps0={eps0:.6g} "
            f"(took {time.time() - t0:.2f}s)"
        )
    else:
        eps0 = float(opts.init_step_size)
        logger.log(f"initial step size: provided eps0={eps0:.6g}")
    eps0 = _clamp(eps0)
    mu0 = max(eps_min, float(opts.dual_averaging_mu_factor) * eps0)

    da = DualAveragingState(mu=math.log(mu0), log_eps=math.log(eps0),
                            log_eps_bar=math.log(eps0), h_bar=0.0, t=0)
    step_size = eps0

    windows = make_warmup_windows(
        num_warmup,
        min_no_window=opts.warmup_min_no_window,
        large_threshold=opts.warmup_large_threshold,
        large_init_buffer=opts.warmup_large_init_buffer,
        large_term_buffer=opts.warmup_large_term_buffer,
        large_base_window=opts.warmup_large_base_window,
        init_buffer_ratio=opts.warmup_init_buffer_ratio,
        term_buffer_ratio=opts.warmup_term_buffer_ratio,
        base_window_divisor=opts.warmup_base_window_divisor,
    )
    window_end_set = {end for _s, end in windows}
    logger.log(describe_windows(windows))
    rv = RunningDiagVar(dim)

    q = q_init

    warmup = {
        "warmup_eps": np.empty(num_warmup),
        "warmup_accept": np.empty((num_warmup, chains)),
        "warmup_div": np.empty((num_warmup, chains), dtype=bool),
        "warmup_depth": np.empty((num_warmup, chains), dtype=int),
        "warmup_nlf": np.empty((num_warmup, chains), dtype=int),
        "warmup_log_target": np.empty((num_warmup, chains)),
    }

    logger.log("warmup: start")
    t_warm0 = time.time()
    for t in range(num_warmup):
        q, a, nlf, depth, div, lp = _step_chains(
            transition, draws, q, step_size, gnp.asarray(inv_mass_diag), delta_max)
        q_host, lp_host = _to_host(q, lp)
        warmup["warmup_accept"][t] = a
        warmup["warmup_div"][t] = div
        warmup["warmup_depth"][t] = depth
        warmup["warmup_nlf"][t] = nlf
        warmup["warmup_log_target"][t] = lp_host
        warmup["warmup_eps"][t] = step_size

        mean_accept = float(np.mean(a))
        mean_div = float(np.mean(div))

        step_size = _clamp(
            da.update(
                mean_accept, target=target_accept,
                gamma=opts.dual_averaging_gamma, t0=opts.dual_averaging_t0,
                kappa=opts.dual_averaging_kappa,
            )
        )

        if any(start <= t < end for start, end in windows):
            rv.update_batch(q_host)

        if (t + 1) in window_end_set:
            old_mean = float(np.mean(mass_diag))
            mass_diag = np.clip(rv.var(), jitter, None)
            inv_mass_diag = 1.0 / mass_diag
            logger.log(
                f"warmup iter {t + 1}: mass update at window end; "
                f"mean(mass_diag) {old_mean:.6g} -> "
                f"{float(np.mean(mass_diag)):.6g}"
            )
            rv = RunningDiagVar(dim)
            mu_ref = max(eps_min, float(opts.dual_averaging_mu_factor) * step_size)
            da = DualAveragingState(
                mu=math.log(mu_ref), log_eps=math.log(step_size),
                log_eps_bar=math.log(step_size), h_bar=0.0, t=0,
            )
            logger.log(
                f"warmup iter {t + 1}: dual averaging restart; "
                f"eps={step_size:.6g}"
            )

        do_log = ((t + 1) % max(1, log_every) == 0) or t == 0 or (
            t + 1 == num_warmup
        )
        if int(opts.verbose) >= 2:
            do_log = ((t + 1) % max(1, log_every // 5) == 0) or do_log
        if do_log:
            logger.log(
                f"warmup iter {t + 1}/{num_warmup}: eps={step_size:.6g}, "
                f"mean_accept={mean_accept:.3f}, div_rate={mean_div:.3f}"
            )

    warmup_time = time.time() - t_warm0
    step_size_final = _clamp(da.final())
    step_size = step_size_final
    logger.log(f"warmup: done in {warmup_time:.2f}s")
    logger.log(f"warmup: step_size_final={step_size_final:.6g}")
    logger.log(f"warmup: mass_diag_final mean={float(np.mean(mass_diag)):.6g}")

    traces = {
        "samples": np.empty((num_samples, chains, dim)),
        "accept": np.empty((num_samples, chains)),
        "divergent": np.empty((num_samples, chains), dtype=bool),
        "tree_depth": np.empty((num_samples, chains), dtype=int),
        "n_leapfrog": np.empty((num_samples, chains), dtype=int),
        "log_target": np.empty((num_samples, chains)),
    }
    meta = {
        "kind": "NUTS", "num_samples": int(num_samples),
        "chains": int(chains), "dim": int(dim),
        "max_depth": int(max_depth), "delta_max": float(delta_max),
        "step_size": float(step_size),
        "step_size_final": float(step_size_final),
        "checkpoint_every": int(opts.checkpoint_every),
    }
    logger.log("sample: start")
    t_samp0 = time.time()
    saver = None
    if opts.checkpoint_path is not None:
        saver = _make_nuts_saver(opts.checkpoint_path, generator, mass_diag, traces,
                                 warmup, meta)
    _run_sampling(transition, draws, q, 0, traces, step_size, inv_mass_diag,
                  delta_max, max(1, int(opts.checkpoint_every)), saver)
    logger.log(
        f"sample: mean_accept={float(np.mean(traces['accept'])):.3f}, "
        f"div_rate={float(np.mean(traces['divergent'])):.3f}"
    )
    logger.log(f"sample: done in {time.time() - t_samp0:.2f}s")
    return gnp.asarray(traces["samples"]), _info(traces, warmup, step_size_final, mass_diag)


def _to_host(q, lp):
    """(q (C, d), lp (C,)) as host arrays, in one transfer."""
    C = q.shape[0]
    flat = torch.cat([q.reshape(-1), lp.reshape(-1)]).to(
        device="cpu", dtype=torch.float64).numpy()
    return flat[:-C].reshape(q.shape), flat[-C:]


def _info(traces, warmup, step_size_final, mass_diag):
    return {
        "warmup_step_size": warmup["warmup_eps"],
        "warmup_accept_stat": warmup["warmup_accept"],
        "warmup_divergent": warmup["warmup_div"],
        "warmup_tree_depth": warmup["warmup_depth"],
        "warmup_log_prob_trace": warmup["warmup_log_target"],
        "warmup_n_leapfrog": warmup["warmup_nlf"],
        "accept_stat": traces["accept"],
        "divergent": traces["divergent"],
        "tree_depth": traces["tree_depth"],
        "n_leapfrog": traces["n_leapfrog"],
        "log_prob_trace": traces["log_target"],
        "step_size_final": step_size_final,
        "mass_diag_final": np.array(mass_diag, dtype=float),
    }


# ---------------------------
# sampling phase, checkpoint / resume
# ---------------------------
def _run_sampling(transition, draws, q, t_start, traces, step_size, inv_mass_diag,
                  delta_max, chunk, save_fn):
    """The frozen-parameter sampling phase from step ``t_start``, filling
    ``traces`` in place and calling ``save_fn(q, t_done)`` (if given) every
    ``chunk`` steps and at the end."""
    num_samples = traces["samples"].shape[0]
    imd = gnp.asarray(inv_mass_diag)
    for t in range(int(t_start), num_samples):
        q, a, nlf, depth, div, lp = _step_chains(transition, draws, q, step_size, imd,
                                                 delta_max)
        traces["samples"][t], traces["log_target"][t] = _to_host(q, lp)
        traces["accept"][t] = a
        traces["divergent"][t] = div
        traces["tree_depth"][t] = depth
        traces["n_leapfrog"][t] = nlf
        if save_fn is not None and ((t + 1) % chunk == 0 or t + 1 == num_samples):
            save_fn(q, t + 1)
    return q


def _make_nuts_saver(path, generator, mass_diag, traces, warmup_arrays, meta_common):
    def save_fn(q, t_done):
        from .checkpoint import save_sampler_checkpoint

        arrays = {"q": gnp.to_np(q), "mass_diag": np.asarray(mass_diag),
                  "generator_state": generator.get_state().numpy().copy()}
        arrays.update({f"trace_{k}": v for k, v in traces.items()})
        arrays.update(warmup_arrays)
        meta = dict(meta_common)
        meta["t_done"] = int(t_done)
        save_sampler_checkpoint(path, arrays, meta)

    return save_fn


def nuts_resume(log_prob, checkpoint_path, verbose=1):
    """Resume an interrupted nuts_sample run whose options set
    checkpoint_path; returns the same (samples, info) the uninterrupted
    run would have (bitwise the same traces).  The caller re-supplies the
    log-probability function; everything else is in the snapshot."""
    from .checkpoint import load_sampler_checkpoint

    arrays, meta = load_sampler_checkpoint(checkpoint_path)
    if meta.get("kind") != "NUTS":
        raise ValueError(f"Not a NUTS checkpoint: {meta.get('kind')!r}")
    logger = SimpleLogger(verbose=verbose)
    num_samples = meta["num_samples"]
    dim = meta["dim"]
    t_done = meta["t_done"]
    mass_diag = np.asarray(arrays["mass_diag"], dtype=float)
    q = gnp.asarray(np.array(arrays["q"], dtype=float))
    generator = torch.Generator()
    generator.set_state(torch.from_numpy(np.array(arrays["generator_state"], dtype=np.uint8)))

    traces = {k: np.array(arrays[f"trace_{k}"]) for k in
              ("samples", "accept", "divergent", "tree_depth", "n_leapfrog", "log_target")}
    warmup = {k: np.array(arrays[k]) for k in
              ("warmup_eps", "warmup_accept", "warmup_div", "warmup_depth", "warmup_nlf",
               "warmup_log_target")}
    logger.log(f"nuts_resume: {t_done}/{num_samples} samples done, continuing")
    meta_common = {k: meta[k] for k in ("kind", "num_samples", "chains", "dim", "max_depth",
                                        "delta_max", "step_size", "step_size_final",
                                        "checkpoint_every")}
    transition = _make_transition(log_prob, meta["max_depth"])
    _run_sampling(
        transition, _GeneratorDraws(generator, dim, q.dtype), q, t_done, traces,
        meta["step_size"], 1.0 / mass_diag, meta["delta_max"],
        max(1, int(meta["checkpoint_every"])),
        _make_nuts_saver(checkpoint_path, generator, mass_diag, traces, warmup,
                         meta_common),
    )
    return gnp.asarray(traces["samples"]), _info(traces, warmup, meta["step_size_final"],
                                                 mass_diag)


# ---------------------------
# Diagnostics plots
# ---------------------------
def moving_average(y, window: int):
    """Valid-mode moving average."""
    y = np.asarray(y, dtype=float)
    w = np.ones(int(window)) / float(window)
    return np.convolve(y, w, mode="valid")


def plot_nuts_diagnostics(samples, info, burnin=0, parameter_indices=None,
                          ma_window=25):
    """Trace plots + accept/divergence/step-size diagnostics."""
    import matplotlib.pyplot as plt

    samples = np.asarray(gnp.to_np(samples))
    num_samples, chains, dim = samples.shape
    pidx = parameter_indices or list(range(dim))
    n_rows = len(pidx) + 3
    fig, axes = plt.subplots(n_rows, 1, figsize=(10, min(12, 2.2 * n_rows)),
                             sharex=False)
    for k, pi in enumerate(pidx):
        for c in range(chains):
            axes[k].plot(samples[burnin:, c, pi], lw=0.5)
        axes[k].set_ylabel(f"param {pi}")
    acc = np.asarray(info["accept_stat"]).mean(axis=1)
    axes[-3].plot(acc, lw=0.5)
    if len(acc) >= ma_window:
        axes[-3].plot(
            np.arange(ma_window - 1, len(acc)), moving_average(acc, ma_window)
        )
    axes[-3].set_ylabel("accept")
    axes[-2].plot(np.asarray(info["divergent"]).mean(axis=1), lw=0.5)
    axes[-2].set_ylabel("divergence")
    axes[-1].plot(np.asarray(info["warmup_step_size"]), lw=0.8)
    axes[-1].set_ylabel("warmup eps")
    axes[-1].set_xlabel("iteration")
    plt.tight_layout()
    plt.show()
    return fig
