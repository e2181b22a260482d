# gpmp_tpu_torch/ops/gram.py
"""Matern gram matrix and its parameter pullback: kernels and plain versions.

K1 (``matern_gram_cuda``) computes
    K_ij = s2 * k_p(||e^l * x_i - e^l * y_j||)  (+ 10 * s2 * eps on the
    diagonal when ``same``), theta = [log s2, l_1..l_d],
and K2 (``matern_gram_pullback_cuda``) computes grad_theta <Kbar, K(theta)>
without forming dK/dtheta.  K1m (``maternp_kernel_cuda``,
``maternp_kernel_backward_cuda``) is the Matern polynomial alone, for
covariances that compose it with ``gnp.scaled_distance`` (K1d,
ops/distance.py): K = k_p(D) and Dbar = Kbar k_p'(D), one elementwise pass
each.  All are hand-written CUDA (gpmp_tpu_torch/csrc/matern_gram.cu).
They replace the gram construction that the JAX package composes from
gpmp_tpu/num cdist/scaled_distance and gpmp_tpu/kernel/matern.py, and its
autodiff pullback.

``matern_gram`` and ``maternp_kernel`` dispatch on the tensors' device: CPU
tensors take the plain PyTorch versions (``matern_gram_plain``,
``matern_gram_pullback_plain``, ``maternp_kernel_plain``,
``maternp_kernel_backward_plain``), CUDA tensors launch the kernels or
raise.  There is no fallback from one to the other, and the plain versions
call only plain versions.

K1 and K2 share one launch geometry, ``gram_plan``: a persistent grid
walking TILE x TILE output tiles, for ``same`` (x is y) only the pairs
I <= J, each computed once and, by K1, written to both places; K2 weighs
such a pair by Kbar_ij + Kbar_ji and is finished by its last block
(csrc/fixed_sum.cuh) into a workspace cached per shape.  Each is one
launch.

K1p (``matern_gram_population_cuda``) and K2p
(``matern_gram_population_pullback_cuda``) are K1 and K2 for a population
of B parameter vectors at one x and y, one launch each on
``population_plan``'s grid; member b of K1p is bitwise K1(theta_b).  They
are what ``torch.func.vmap`` of ``matern_gram`` over theta runs on CUDA
tensors (``MaternGram.vmap`` and ``_GramPullback.vmap``: the SMC and SVGD
samplers' population criterion, mcmc.population); any other batching of
CUDA tensors raises NotImplementedError.

``K1_LAUNCHES``, ``K2_LAUNCHES``, ``K1P_LAUNCHES``, ``K2P_LAUNCHES``,
``K1M_LAUNCHES`` and ``K1M_BACKWARD_LAUNCHES`` count kernel launches (one
per wrapper call that launched); the plain versions count nothing.

eps in the nugget is the machine epsilon of the tensors' dtype (the
working dtype when the tensors come from ``gnp``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from functools import partial

import torch

import gpmp_tpu_torch.num as gnp
from . import _build, capture, distance
from .autograd import (SecondOrderNotImplemented, functorch_active, plain_vjp, plain_vjp_func,
                       refuse_batched)
from .mixed import _on_card, _sms_on

K1_LAUNCHES = 0
K2_LAUNCHES = 0
K1P_LAUNCHES = 0
K2P_LAUNCHES = 0
K1M_LAUNCHES = 0
K1M_BACKWARD_LAUNCHES = 0


# ----------------------------------------------------------------------------
# Matern polynomial (shared by the plain versions and the kernels)
# ----------------------------------------------------------------------------
def _maternp_poly_coeffs(p: int):
    """Coefficients a_k of the half-integer Matern polynomial.

    K(h) = exp(-2 sqrt(nu) h) * sum_{k=0}^{p} a_k (4 sqrt(nu) h)^k with
    a_k = Gamma(p+1)/Gamma(2p+1) * (2p-k)! / ((p-k)! k!); a_0 = 1.
    """
    return [
        math.exp(
            math.lgamma(p + 1)
            - math.lgamma(2 * p + 1)
            + math.lgamma(2 * p - k + 1)
            - math.lgamma(p - k + 1)
            - math.lgamma(k + 1)
        )
        for k in range(p + 1)
    ]


def _maternp_dpoly_coeffs(p: int):
    """b_k with k_p'(h) = c e^{-ch} sum_k b_k (2ch)^k: b_k = 2(k+1)a_{k+1} - a_k."""
    a = _maternp_poly_coeffs(p) + [0.0]
    return [2.0 * (k + 1) * a[k + 1] - a[k] for k in range(p + 1)]


def _horner(coeffs, t):
    poly = torch.full_like(t, coeffs[-1])
    for ck in reversed(coeffs[:-1]):
        poly = poly * t + ck
    return poly


# ----------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are held to)
# ----------------------------------------------------------------------------
def maternp_kernel_plain(p: int, h):
    """Matern kernel with half-integer regularity nu = p + 1/2 (torch ops).

    Polynomial form evaluated by Horner's rule; K(inf) = 0.
    """
    p = int(p)
    c = 2.0 * math.sqrt(p + 0.5)
    if p == 0:
        return torch.exp(-c * h)
    out = torch.exp(-c * h) * _horner(_maternp_poly_coeffs(p), 2.0 * c * h)
    return torch.where(torch.isinf(h), torch.zeros_like(out), out)


def maternp_kernel_backward_plain(p: int, h, kbar):
    """Hbar = Kbar k_p'(h), k_p'(h) = c e^{-ch} sum_k b_k (2ch)^k; 0 at h = inf."""
    c = 2.0 * math.sqrt(int(p) + 0.5)
    dk = c * torch.exp(-c * h) * _horner(_maternp_dpoly_coeffs(int(p)), 2.0 * c * h)
    return torch.where(torch.isinf(h), 0.0, kbar * dk)


def matern_gram_plain(x, y, p, theta, same=False):
    """K(x, y; theta) from torch ops: the JAX package's composition."""
    sigma2 = torch.exp(theta[0])
    K = sigma2 * maternp_kernel_plain(p, distance.scaled_distance_plain(theta[1:], x, y))
    if same:
        nugget = 10.0 * sigma2 * torch.finfo(x.dtype).eps
        K = K + nugget * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return K


def matern_gram_population_plain(x, y, p, thetas, same=False):
    """(B, n, m): K(x, y; theta_b) for the rows theta_b of thetas (B, 1 + d),
    the single plain version under torch.func.vmap."""
    return torch.func.vmap(lambda t: matern_gram_plain(x, y, p, t, same))(thetas)


def matern_gram_population_pullback_plain(kbars, x, y, p, thetas, same=False):
    """(B, 1 + d) float64: grad_theta_b <kbars[b], K(x, y; theta_b)>, the single
    plain version under torch.func.vmap."""
    return torch.func.vmap(
        lambda kb, t: matern_gram_pullback_plain(kb, x, y, p, t, same))(kbars, thetas)


def matern_gram_pullback_plain(kbar, x, y, p, theta, same=False):
    """grad_theta <kbar, K(x, y; theta)> from torch ops, accumulated in float64.

    Rows are taken in blocks under gnp._CDIST_BLOCK_BUDGET, as in gnp.cdist.
    Coincident points (h = 0) contribute 0 to the log-inverse-range
    components (the zero subgradient of gnp._safe_sqrt).
    """
    p = int(p)
    n, d = x.shape
    m = y.shape[0]
    sigma2 = torch.exp(theta[0])
    invrho = torch.exp(theta[1:])
    xs, ys = invrho * x, invrho * y
    c = 2.0 * math.sqrt(p + 0.5)
    a, b = _maternp_poly_coeffs(p), _maternp_dpoly_coeffs(p)
    block = max(1, gnp._CDIST_BLOCK_BUDGET // (m * max(d, 1)))
    g0, gl = [], []
    for i in range(0, n, block):
        sq = (xs[i:i + block, None, :] - ys[None, :, :]) ** 2
        h = torch.sqrt(torch.sum(sq, dim=-1))
        e = torch.exp(-c * h)
        t = 2.0 * c * h
        finite = ~torch.isinf(h)
        kv = torch.where(finite, e * _horner(a, t), 0.0)
        kb = kbar[i:i + block]
        g0.append(torch.sum((kb * (sigma2 * kv)).double()))
        pos = finite & (h > 0.0)
        w = torch.where(pos, kb * sigma2 * (c * e * _horner(b, t))
                        / torch.where(pos, h, 1.0), 0.0)
        gl.append(torch.sum((w[..., None] * sq).double(), dim=(0, 1)))
    g_sigma = torch.stack(g0).sum()
    if same:
        nugget = 10.0 * sigma2 * torch.finfo(x.dtype).eps
        g_sigma = g_sigma + torch.sum((torch.diagonal(kbar) * nugget).double())
    return torch.cat([g_sigma.reshape(1), torch.stack(gl).sum(0)])


# ----------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ----------------------------------------------------------------------------
# K1's and K2's geometry (csrc/matern_gram.cu, checked against the built
# library once): blocks of THREADS threads on TILE x TILE output tiles, a
# thread C = 16 / itemsize consecutive columns (one 16-byte access) of
# TILE C / THREADS rows (lane l the columns C (l % (TILE / C)) .., rows
# RW warp + l // (TILE / C) + s RW THREADS / 32, RW = 32 C / TILE); for
# p up to FIXED_P (the zero-padded degree-FIXED_P Horner, the coefficients
# by value) an instance for each d up to EXACT_MAX_D, else one for d up
# to MAX_D; BLOCKS_PER_SM blocks an SM (the instances are built for it:
# 128 registers a thread).
THREADS, TILE, EXACT_MAX_D, MAX_D, FIXED_P = 128, 32, 8, 32, 3
BLOCKS_PER_SM = 4
# K1p's and K2p's (population_plan): blocks of POP_THREADS threads; K1p a
# thread an entry, POP_CHUNK entries of up to POP_MAX_MEMBERS whole members a
# block; K2p a warp POP_WARP_ENTRIES entries of one member; an instance
# unrolled to d <= POP_EXACT_D, else the run-time-d one
POP_THREADS, POP_CHUNK, POP_MAX_MEMBERS, POP_WARP_ENTRIES, POP_EXACT_D = 256, 512, 64, 1024, 8


def gram_plan(n, m, same, itemsize, sms):
    """The K1/K2 grid for K (n, m) in ``itemsize``-byte entries, on the
    CPU: (tile, items, blocks).

    Items are TILE x TILE output tiles (I, J): for ``same`` (x is y, n = m)
    the pairs I <= J, item t = J (J + 1) / 2 + I; else every (I, J), item
    t = I tj + J (tj = ceil(m / TILE)).  Block b takes the items b,
    b + blocks, ... in order; there are at most BLOCKS_PER_SM blocks an SM
    (n = 1000, same, on the H100's 132 SMs: 528 items on 528 blocks; the
    cross 1000 x 1000: 1024 items)."""
    if n <= 0 or m <= 0 or itemsize not in (4, 8) or sms <= 0 or (same and n != m):
        raise ValueError(f"gram_plan: n={n}, m={m}, same={same}, itemsize={itemsize}, "
                         f"sms={sms}")
    ti, tj = -(-n // TILE), -(-m // TILE)
    items = ti * (ti + 1) // 2 if same else ti * tj
    return TILE, items, min(items, BLOCKS_PER_SM * sms)


def population_plan(members, n, m):
    """K1p's and K2p's grids for B = ``members`` grams (n, m), on the CPU:
    ((mb, chunks, blocks), (chunks, blocks)).

    K1p: mb members a block (as many whole members as POP_CHUNK entries
    hold, at most POP_MAX_MEMBERS; one past POP_CHUNK entries), their
    mb n m entries cut into ``chunks`` blocks of POP_CHUNK; K2p: a member's
    n m entries cut into ``chunks`` warps of POP_WARP_ENTRIES, POP_THREADS /
    32 warps a block.  (B, n) = (1000, 8): K1p 125 blocks of 8 members, K2p
    1000 warps; (64, 512): K1p 64 x 512 blocks, K2p 64 x 256 warps."""
    if members <= 0 or n <= 0 or m <= 0:
        raise ValueError(f"population_plan: members={members}, n={n}, m={m}")
    per = n * m
    mb = max(1, min(POP_MAX_MEMBERS, POP_CHUNK // per))
    chunks = -(-(mb * per) // POP_CHUNK)
    warps_chunks = -(-per // POP_WARP_ENTRIES)
    warps = POP_THREADS // 32
    return ((mb, chunks, -(-members // mb) * chunks),
            (warps_chunks, -(-(members * warps_chunks) // warps)))


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, its K1/K2 geometry checked against this module's
    once."""
    lib = _build.load()
    want = (THREADS, TILE, EXACT_MAX_D, MAX_D, FIXED_P, BLOCKS_PER_SM)
    built = tuple(lib.gpmp_matern_geometry(q) for q in range(len(want)))
    if built != want:
        raise RuntimeError(f"csrc/matern_gram.cu's K1/K2 geometry (threads, tile, exact d, "
                           f"max d, fixed p, blocks an SM) is {built}, not {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _population_library():
    """The kernel library, its K1p/K2p geometry checked against this
    module's once."""
    lib = _library()
    want = (POP_THREADS, POP_CHUNK, POP_MAX_MEMBERS, POP_WARP_ENTRIES, POP_EXACT_D)
    built = tuple(lib.gpmp_matern_population_geometry(q) for q in range(len(want)))
    if built != want:
        raise RuntimeError(f"csrc/matern_gram.cu's K1p/K2p geometry (threads, chunk, members, "
                           f"warp entries, exact d) is {built}, not {want}")
    return lib


@functools.lru_cache(maxsize=64)
def _plan_on(device, n, m, same, itemsize):
    _library()
    return gram_plan(n, m, same, itemsize, _sms_on(device))


@capture.cached(maxsize=64)
def _pullback_workspace(device, n, m, d, dtype, same):
    """K2's per-(device, n, m, d, dtype, same) workspace: its plan, and raw
    pointers to the blocks' partial sums (1 + MAX_D f64 a block) and to the
    ticket (int32, zero between launches: each launch resets it), beside
    the tensors that hold them."""
    plan = _plan_on(device, n, m, same, torch.finfo(dtype).bits // 8)
    part = torch.empty(plan[-1] * (1 + MAX_D), dtype=torch.float64, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    return plan, part.data_ptr(), ticket.data_ptr(), (part, ticket)


@capture.cached(maxsize=64)
def _population_pullback_workspace(device, members, n, m, d):
    """K2p's per-(device, B, n, m, d) workspace: its chunks and blocks, and raw
    pointers to the chunks' sums (B x chunks x (1 + d) f64) and to the
    members' tickets (int32, zero between launches: each launch resets
    them), beside the tensors that hold them."""
    _population_library()
    chunks, blocks = population_plan(members, n, m)[1]
    part = torch.empty(members * chunks * (d + 1) if chunks > 1 else 1,
                       dtype=torch.float64, device=device)
    ticket = torch.zeros(members, dtype=torch.int32, device=device)
    return chunks, blocks, part.data_ptr(), ticket.data_ptr(), (part, ticket)


def _coef_values(p):
    """[c, a_0..a_p, b_0..b_p], c = 2 sqrt(p + 1/2)."""
    return [2.0 * math.sqrt(p + 0.5), *_maternp_poly_coeffs(p), *_maternp_dpoly_coeffs(p)]


_COEF = {}  # (p, device) -> float64 [c, a_0..a_p, b_0..b_p] on the device


def _coef_tensor(p, device):
    key = (p, device)
    t = _COEF.get(key)
    if t is None:
        t = _COEF[key] = torch.tensor(_coef_values(p), dtype=torch.float64, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _host_coef(p):
    """The coefficients on the host (a ctypes array the launch reads)."""
    vals = _coef_values(p)
    return (ctypes.c_double * len(vals))(*vals)


def _coef_args(p, device):
    """(host, device) coefficient pointers of a K1/K2 launch: the device
    array only where the kernels read it (p > FIXED_P)."""
    return _host_coef(p), (_coef_tensor(p, device).data_ptr() if p > FIXED_P else None)


def _check_cuda_args(x, y, theta, p, same, kbar=None):
    """Validate the kernels' arguments before anything is built or launched."""
    tensors = (x, y, theta) if kbar is None else (kbar, x, y, theta)
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("matern gram kernels take CUDA tensors on one device")
        if t.dtype not in (torch.float64, torch.float32) or t.dtype != x.dtype:
            raise ValueError("matern gram kernels take float64 or float32 "
                             "tensors of one dtype")
        if not t.is_contiguous():
            raise ValueError("matern gram kernels take contiguous tensors")
    if x.ndim != 2 or y.ndim != 2 or y.shape[1] != x.shape[1]:
        raise ValueError(f"x, y must be (n, d), (m, d); got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    n, d = x.shape
    m = y.shape[0]
    if d < 1:
        raise ValueError("the kernels need d >= 1")
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the kernels' compile-time maximum {MAX_D}")
    if theta.shape != (d + 1,):
        raise ValueError(f"theta must have shape ({d + 1},); got {tuple(theta.shape)}")
    if p < 0:
        raise ValueError(f"p must be >= 0; got {p}")
    if same and (y.data_ptr() != x.data_ptr() or y.shape != x.shape):
        raise ValueError("same=True needs y to be x")
    if kbar is not None and kbar.shape != (n, m):
        raise ValueError(f"kbar must be ({n}, {m}); got {tuple(kbar.shape)}")
    return n, m, d


def matern_gram_cuda(x, y, p, theta, same=False):
    """K1: the gram matrix on the card, one launch on gram_plan's grid
    (``same``: y is x, each pair computed once and written to both places)."""
    global K1_LAUNCHES
    n, m, d = _check_cuda_args(x, y, theta, p, same)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    plan = _plan_on(x.device, n, m, bool(same), x.element_size())
    _build.launch("K1 matern_gram", getattr(_library(), f"gpmp_matern_gram_{distance._suffix(x)}"),
                  x.device, x.data_ptr(), y.data_ptr(), theta.data_ptr(),
                  *_coef_args(p, x.device), out.data_ptr(), n, m, d, p, int(same),
                  torch.finfo(x.dtype).eps, *plan)
    K1_LAUNCHES += 1
    return out


def matern_gram_pullback_cuda(kbar, x, y, p, theta, same=False):
    """K2: grad_theta <kbar, K(theta)> on the card, float64 of shape (1 + d,).

    One launch on gram_plan's grid, finished by its last block (fixed
    order, no atomics on values: bitwise reproducible)."""
    global K2_LAUNCHES
    n, m, d = _check_cuda_args(x, y, theta, p, same, kbar=kbar)
    if n == 0 or m == 0:
        return torch.zeros(d + 1, dtype=torch.float64, device=x.device)
    plan, part, ticket, _ = _pullback_workspace(x.device, n, m, d, x.dtype, bool(same))
    out = torch.empty(d + 1, dtype=torch.float64, device=x.device)
    _build.launch("K2 matern_gram_pullback",
                  getattr(_library(), f"gpmp_matern_pullback_{distance._suffix(x)}"), x.device,
                  kbar.data_ptr(), x.data_ptr(), y.data_ptr(), theta.data_ptr(),
                  *_coef_args(p, x.device), part, ticket, out.data_ptr(), n, m, d, p,
                  int(same), torch.finfo(x.dtype).eps, *plan)
    K2_LAUNCHES += 1
    return out


def _check_population_args(x, y, thetas, p, same, kbars=None):
    """Validate K1p's and K2p's arguments: K1's and K2's for each member,
    thetas (B, 1 + d) and kbars (B, n, m)."""
    if thetas.ndim != 2 or thetas.shape[0] < 1:
        raise ValueError(f"thetas must be (B, 1 + d) with B >= 1; got {tuple(thetas.shape)}")
    n, m, d = _check_cuda_args(x, y, thetas[0], p, same)
    for t in (thetas,) if kbars is None else (thetas, kbars):
        if not t.is_cuda or t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("population gram kernels take contiguous CUDA tensors of x's "
                             "device and dtype")
    B = thetas.shape[0]
    if kbars is not None and kbars.shape != (B, n, m):
        raise ValueError(f"kbars must be ({B}, {n}, {m}); got {tuple(kbars.shape)}")
    return B, n, m, d


def matern_gram_population_cuda(x, y, p, thetas, same=False):
    """K1p: the B grams K(x, y; theta_b), (B, n, m), one launch on
    population_plan's grid; member b bitwise K1(theta_b)."""
    global K1P_LAUNCHES
    B, n, m, d = _check_population_args(x, y, thetas, p, same)
    out = torch.empty((B, n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    mb, chunks, blocks = population_plan(B, n, m)[0]
    _build.launch("K1p matern_gram_population",
                  getattr(_population_library(),
                          f"gpmp_matern_gram_population_{distance._suffix(x)}"),
                  x.device, x.data_ptr(), y.data_ptr(), thetas.data_ptr(),
                  *_coef_args(p, x.device), out.data_ptr(), B, n, m, d, p, int(same),
                  torch.finfo(x.dtype).eps, mb, chunks, blocks)
    K1P_LAUNCHES += 1
    return out


def matern_gram_population_pullback_cuda(kbars, x, y, p, thetas, same=False):
    """K2p: grad_theta_b <kbars[b], K(theta_b)>, (B, 1 + d) float64, one launch
    on population_plan's grid, each member finished in a fixed order
    (bitwise reproducible)."""
    global K2P_LAUNCHES
    B, n, m, d = _check_population_args(x, y, thetas, p, same, kbars=kbars)
    if n == 0 or m == 0:
        return torch.zeros((B, d + 1), dtype=torch.float64, device=x.device)
    chunks, blocks, part, ticket, _ = _population_pullback_workspace(x.device, B, n, m, d)
    out = torch.empty((B, d + 1), dtype=torch.float64, device=x.device)
    _build.launch("K2p matern_gram_population_pullback",
                  getattr(_population_library(),
                          f"gpmp_matern_pullback_population_{distance._suffix(x)}"),
                  x.device, kbars.data_ptr(), x.data_ptr(), y.data_ptr(), thetas.data_ptr(),
                  *_coef_args(p, x.device), part, ticket, out.data_ptr(), B, n, m, d, p,
                  int(same), torch.finfo(x.dtype).eps, chunks, blocks)
    K2P_LAUNCHES += 1
    return out


def _check_maternp_args(p, h, kbar=None):
    for t in (h,) if kbar is None else (h, kbar):
        if not t.is_cuda or t.device != h.device:
            raise ValueError("K1m maternp kernels take CUDA tensors on one device")
        if t.dtype not in (torch.float64, torch.float32) or t.dtype != h.dtype:
            raise ValueError("K1m maternp kernels take float64 or float32 tensors of one dtype")
        if not t.is_contiguous():
            raise ValueError("K1m maternp kernels take contiguous tensors")
    if kbar is not None and kbar.shape != h.shape:
        raise ValueError(f"kbar must be {tuple(h.shape)}; got {tuple(kbar.shape)}")
    if p < 0:
        raise ValueError(f"p must be >= 0; got {p}")
    return _build.load()


def maternp_kernel_cuda(p, h):
    """K1m on the card: k_p(h) elementwise, any shape (one launch)."""
    global K1M_LAUNCHES
    lib = _check_maternp_args(p, h)
    out = torch.empty_like(h)
    if h.numel() == 0:
        return out
    fn = lib.gpmp_maternp_f64 if h.dtype == torch.float64 else lib.gpmp_maternp_f32
    _build.launch("K1m maternp", fn, h.device, h.data_ptr(), _coef_tensor(p, h.device).data_ptr(),
                  out.data_ptr(), h.numel(), p)
    K1M_LAUNCHES += 1
    return out


def maternp_kernel_backward_cuda(p, h, kbar):
    """K1m backward on the card: kbar * k_p'(h) elementwise (one launch)."""
    global K1M_BACKWARD_LAUNCHES
    lib = _check_maternp_args(p, h, kbar)
    out = torch.empty_like(h)
    if h.numel() == 0:
        return out
    fn = (lib.gpmp_maternp_backward_f64 if h.dtype == torch.float64
          else lib.gpmp_maternp_backward_f32)
    _build.launch("K1m maternp backward", fn, h.device, h.data_ptr(), kbar.data_ptr(),
                  _coef_tensor(p, h.device).data_ptr(), out.data_ptr(), h.numel(), p)
    K1M_BACKWARD_LAUNCHES += 1
    return out


# ----------------------------------------------------------------------------
# Autograd and dispatch
# ----------------------------------------------------------------------------
class _MaternpKernel(torch.autograd.Function):
    """k_p(h) elementwise: K1m forward and backward on CUDA tensors, the
    plain versions on CPU tensors; under create_graph the backward is the
    plain composition's, recorded (exact second derivatives).  Under
    torch.func.vmap the rule is generated from these: on CPU tensors the
    plain versions batch, on CUDA tensors K1m has no population form and
    raises."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h, p):
        if _on_card(h):
            refuse_batched("K1m maternp_kernel", h)
            return maternp_kernel_cuda(p, h.contiguous())
        return maternp_kernel_plain(p, h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, p = inputs
        ctx.save_for_backward(h)
        ctx.p = p

    @staticmethod
    def backward(ctx, kbar):
        (h,) = ctx.saved_tensors
        if torch.is_grad_enabled():
            (hbar,) = plain_vjp(partial(maternp_kernel_plain, ctx.p), (h,),
                                ctx.needs_input_grad[:1], kbar)
            return hbar, None
        if _on_card(h):
            refuse_batched("K1m maternp_kernel backward", h, kbar)
            return maternp_kernel_backward_cuda(ctx.p, h.contiguous(), kbar.contiguous()), None
        return maternp_kernel_backward_plain(ctx.p, h, kbar), None


def maternp_kernel(p: int, h):
    """Matern kernel with half-integer regularity nu = p + 1/2, elementwise
    on a tensor of distances h (or a NumPy array, as gnp's ops take it);
    K(inf) = 0; differentiable in h."""
    return _MaternpKernel.apply(gnp._tensor(h), int(p))


def matern_gram_population(x, y, p, thetas, same=False):
    """(B, n, m): K(x, y; theta_b) for the rows of thetas (B, 1 + d): K1p on
    CUDA tensors, the plain version on CPU tensors."""
    if _on_card(thetas):
        return matern_gram_population_cuda(*_contiguous_pair(x, y), p, thetas.contiguous(), same)
    return matern_gram_population_plain(x, y, p, thetas, same)


def matern_gram_population_pullback(kbars, x, y, p, thetas, same=False):
    """(B, 1 + d) float64: grad_theta_b <kbars[b], K(x, y; theta_b)>: K2p on
    CUDA tensors, the plain version on CPU tensors."""
    if _on_card(thetas):
        return matern_gram_population_pullback_cuda(kbars.contiguous(), *_contiguous_pair(x, y),
                                                     p, thetas.contiguous(), same)
    return matern_gram_population_pullback_plain(kbars, x, y, p, thetas, same)


def _population_dims(name, xd, yd, tensors):
    """The batching of a gram Function under torch.func.vmap: theta batched
    (or broadcast) and x, y shared is the population form; any other on CUDA
    tensors raises, naming the case."""
    if xd is None and yd is None:
        return True
    if any(t.is_cuda for t in tensors):
        raise NotImplementedError(
            f"{name} under torch.func.vmap on CUDA tensors batches theta only (a population "
            f"of parameter vectors at one x and y: K1p/K2p); got x batched along {xd}, "
            f"y along {yd}")
    return False


def _members(t, dim, size):
    """t with its batch dimension first (dim None: broadcast to size)."""
    return t.movedim(dim, 0) if dim is not None else t.expand(size, *t.shape)


class _GramPullback(torch.autograd.Function):
    """g = grad_theta <kbar, K(x, y; theta)>, (1 + d) in theta's dtype: the
    theta pullback of MaternGram under torch.func transforms (K2 on CUDA
    tensors, the plain version on CPU tensors); its vmap rule, for a batch
    of (kbar, theta) at one x and y, is K2p.  First-order only."""

    @staticmethod
    def forward(kbar, x, y, theta, p, same):
        if kbar.is_cuda:
            g = matern_gram_pullback_cuda(kbar.contiguous(), *_contiguous_pair(x, y), p,
                                          theta.contiguous(), same)
        else:
            g = matern_gram_pullback_plain(kbar, x, y, p, theta, same)
        return g.to(theta.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, kbar, x, y, theta, p, same):
        kd, xd, yd, td = in_dims[:4]
        if not _population_dims("the gram pullback", xd, yd, (kbar, x, y, theta)):
            return torch.func.vmap(
                lambda kb, xx, yy, t: matern_gram_pullback_plain(kb, xx, yy, p, t, same),
                in_dims=(kd, xd, yd, td), randomness=info.randomness)(
                    kbar, x, y, theta).to(theta.dtype), 0
        B = info.batch_size
        g = matern_gram_population_pullback(_members(kbar, kd, B), x, y, p,
                                            _members(theta, td, B), same)
        return g.to(theta.dtype), 0

    @staticmethod
    def backward(ctx, gbar):
        raise SecondOrderNotImplemented(
            "the gram pullback under torch.func transforms: second derivatives are not "
            "implemented (differentiate MaternGram without torch.func for a Hessian)")


class MaternGram(torch.autograd.Function):
    """K(x, y; theta): K1 forward and K2 (the theta pullback) backward on CUDA
    tensors, the plain versions on CPU tensors.  The x and y cotangents come
    from the plain composition on either device (off the main path), and so
    does the whole backward under create_graph, recorded (exact second
    derivatives).

    Under torch.func transforms: the vmap rule takes a batch of theta at one
    x and y to K1p (the population form; the plain versions on CPU tensors),
    and the backward's theta pullback is ``_GramPullback``, whose vmap rule is
    K2p, so that ``vmap(grad(criterion))`` launches K1p and K2p once a
    population.  Other batchings of CUDA tensors raise NotImplementedError."""

    @staticmethod
    def forward(x, y, theta, p, same):
        if x.is_cuda:
            return matern_gram_cuda(*_contiguous_pair(x, y), p, theta.contiguous(), same)
        return matern_gram_plain(x, y, p, theta, same)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y, theta, p, same = inputs
        ctx.save_for_backward(x, y, theta)
        ctx.p, ctx.same = p, same

    @staticmethod
    def vmap(info, in_dims, x, y, theta, p, same):
        xd, yd, td = in_dims[:3]
        if not _population_dims("MaternGram", xd, yd, (x, y, theta)):
            return torch.func.vmap(partial(_gram_plain_xyt, p, same), in_dims=(xd, yd, td),
                                   randomness=info.randomness)(x, y, theta), 0
        return matern_gram_population(x, y, p, _members(theta, td, info.batch_size), same), 0

    @staticmethod
    def backward(ctx, kbar):
        x, y, theta = ctx.saved_tensors
        plain = partial(_gram_plain_xyt, ctx.p, ctx.same)
        if functorch_active():
            gx, gy, _ = plain_vjp_func(plain, (x, y, theta),
                                       (*ctx.needs_input_grad[:2], False), kbar)
            g = (_GramPullback.apply(kbar, x, y, theta, ctx.p, ctx.same)
                 if ctx.needs_input_grad[2] else None)
            return gx, gy, g, None, None
        if torch.is_grad_enabled():
            return (*plain_vjp(plain, (x, y, theta), ctx.needs_input_grad[:3], kbar), None, None)
        gx = gy = g = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gx, gy, _ = plain_vjp(plain, (x.detach().requires_grad_(ctx.needs_input_grad[0]),
                                          y.detach().requires_grad_(ctx.needs_input_grad[1]),
                                          theta.detach()),
                                  (*ctx.needs_input_grad[:2], False), kbar, create_graph=False)
        if ctx.needs_input_grad[2]:
            if kbar.is_cuda:
                g = matern_gram_pullback_cuda(kbar.contiguous(), *_contiguous_pair(x, y), ctx.p,
                                              theta.contiguous(), ctx.same)
            else:
                g = matern_gram_pullback_plain(kbar, x, y, ctx.p, theta, ctx.same)
            g = g.to(theta.dtype)
        return gx, gy, g, None, None


def _contiguous_pair(x, y):
    """x and y contiguous, y still x where it was x (the same tensor, or a
    saved copy of it): the kernels' ``same`` form takes y to be x."""
    xc = x.contiguous()
    if y is x or (y.data_ptr() == x.data_ptr() and y.shape == x.shape
                  and y.stride() == x.stride()):
        return xc, xc
    return xc, y.contiguous()


def _gram_plain_xyt(p, same, x, y, theta):
    return matern_gram_plain(x, y, p, theta, same)


def matern_gram(x, y, p, theta, same=False):
    """Matern gram K(x, y; theta), differentiable in theta (K2 on the card)
    and in x and y (the plain composition), twice as well (the plain
    composition).

    ``same=True`` (y is x) adds the 10 * s2 * eps nugget on the diagonal.
    """
    if not (x.device == y.device == theta.device):
        raise ValueError("x, y and theta must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return MaternGram.apply(x, y, theta, int(p), bool(same))
