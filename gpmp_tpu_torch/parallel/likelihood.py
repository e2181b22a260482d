# gpmp_tpu_torch/parallel/likelihood.py
"""Large-n GP selection criteria on a mesh.

Counterpart of gpmp_tpu/parallel/likelihood.py: the same profiled REML and
zero-mean NLL as gpmp_tpu_torch.core.likelihood, with K^{-1} [z P] and
log det K from one of three engines:

- the streamed engine (parallel/streamed.py), which never holds the (n, n)
  covariance in float64: one-card mesh, mixed engine configured and n past
  the resident engines' memory (or GPMP_STREAM_N), f32-polymorphic kernel;
- the resident branch, the f64 gram handed to the sharded mixed engine
  (parallel/mixed.py, mixed engine configured) or to the blocked Cholesky
  with refined panels (parallel/chol.py, K8/K9; the f64 engine);
- ``factor=``: a precomputed blocked factor of K, value only.

The model kernel is called as cross-covariance (x_rows, x_full), which
skips its ``y is x`` self-branch; the self-vs-cross diagonal difference
(noise variance + nugget) is measured once per covparam from the full
kernel (``_diag_correction``) and added back on the diagonal.

The gram (``_make_cov``): on the f64 branch ``torch.utils.checkpoint``
recomputes it in the backward (the JAX package's ``jax.checkpoint``), so
the kernel chain's (n, n) autograd residuals are never held; on the mixed
branch its backward reruns the kernel chain in float32 by row chunks,
accumulated in f64 (``_CovF32Backward``), or exactly in f64 where the
kernel is not f32-polymorphic.

On a group mesh (torch.distributed ranks) ``sharded_covariance`` returns
this rank's (n/R, n) row slab, its diagonal correction at the slab's
offset, and the criteria take replicated inputs and return the same
replicated value on every rank: covparam enters each rank's graph through
``comm.replicate`` and the sums over training rows (log det, P' K^-1 P,
P' K^-1 z, z' K^-1 z) leave through ``comm.psum``, so the gradient is the
sum of every rank's part, bitwise the same on every rank.  A group mesh
never streams.
"""

from math import log, pi

import torch
from torch.utils.checkpoint import checkpoint

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.ops.autograd import first_order_only
from gpmp_tpu_torch.core.likelihood import _nan_to_inf
from gpmp_tpu_torch.core.linalg import chol_engine
from . import comm
from .chol import sharded_solve_and_logdet, value_only_wrt

# Points per block of _diag_correction.  Only the block diagonals are read,
# so the size is free: each block costs two host calls of the kernel (two
# K1d/K1m launches each on the card) and block^2 kernel entries.  512 makes
# n = 32768 cost 64 pairs of gram calls (1.7e7 entries, a few ms on the
# card); the JAX package's 32, which XLA vmaps into one program, would be
# 2048 pairs of host calls here.
DIAG_CORRECTION_BLOCK = 512


def _largest_divisor_leq(n, bound):
    """Largest divisor of n that is <= bound (>=1)."""
    best = 1
    i = 1
    while i * i <= n:
        if n % i == 0:
            for c in (i, n // i):
                if best < c <= bound:
                    best = c
        i += 1
    return best


def _diag_correction(model, covparam, xi, block=DIAG_CORRECTION_BLOCK):
    """Self-branch minus cross-branch diagonal (noise variance + nugget, per
    point), computed exactly from the full kernel in O(n block) work; the
    kernel's ``pairwise`` branch may omit the noise (reference-convention
    kernels return prior variances there).  A clone defeats the kernel's
    ``y is x`` test.  Differentiable in covparam."""
    n = xi.shape[0]
    parts = []
    for r0 in range(0, n, block):
        xb = xi[r0:r0 + block]
        K_self = model.covariance(xb, xb, covparam)
        K_cross = model.covariance(xb, xb.clone(), covparam)
        parts.append(torch.diagonal(K_self) - torch.diagonal(K_cross))
    return torch.cat(parts)


def sharded_covariance(model, covparam, xi, mesh, axis_name="shard"):
    """The (n, n) covariance with the self-branch diagonal: the
    cross-covariance plus the measured diagonal correction.  On a group mesh,
    this rank's (n/R, n) row slab, from the replicated points (as the JAX
    package's ``per_shard``)."""
    off, n_loc = comm.rows_of(xi.shape[0], mesh)
    x_loc = xi[off:off + n_loc]
    corr = _diag_correction(model, covparam, x_loc)
    Kl = model.covariance(x_loc, xi.clone(), covparam)  # the clone defeats `y is x`
    # a sum, whose backward hands Kbar on as it is (diagonal_scatter's would
    # copy it: one more n^2 buffer in the value+grad's peak)
    return Kl + torch.zeros_like(Kl).diagonal_scatter(corr.to(Kl.dtype), off)


def _streamed_active(model, covparam, xi, mesh, axis_name):
    """True when the criterion runs on the streamed engine: n past the
    resident engines' memory wall (or GPMP_STREAM_N), mixed engine
    configured, f32-polymorphic kernel."""
    from .streamed import streamed_applicable

    try:
        return streamed_applicable(model, covparam, xi, mesh, axis_name)
    except Exception:
        return False


def _engine_solve_and_logdet(K, rhs, mesh, axis_name, block, factor=None):
    """The resident branch: the sharded mixed engine when configured, else
    the blocked f64 Cholesky (or a precomputed factor of it)."""
    if factor is None and K.dtype == torch.float64 and chol_engine(K.shape[1]) == "mixed":
        from .mixed import sharded_mp_solve_and_logdet

        return sharded_mp_solve_and_logdet(K, rhs, mesh, axis_name=axis_name, block=block)
    return sharded_solve_and_logdet(K, rhs, mesh, axis_name=axis_name, block=block,
                                    factor=factor)


class _CovF32Backward(torch.autograd.Function):
    """p -> K (f64 forward; this rank's slab on a group mesh) whose backward
    pulls Kbar back through the kernel chain in float32 by row chunks, the
    chunks' gradients summed in f64."""

    @staticmethod
    def forward(ctx, p, model, xi, xi32, mesh):
        ctx.model, ctx.xi32, ctx.mesh = model, xi32, mesh
        ctx.save_for_backward(p)
        return sharded_covariance(model, p, xi, mesh)

    @staticmethod
    @first_order_only("the mixed branch's f32 gram backward")
    def backward(ctx, Kbar):
        (p,) = ctx.saved_tensors
        off, _ = comm.rows_of(ctx.xi32.shape[0], ctx.mesh)
        pbar = _chunked_gram_pullback(
            ctx.model, p.to(torch.float32), comm.slab(ctx.xi32, ctx.mesh),
            lambda r0, r1: Kbar[r0:r1].to(torch.float32),
            torch.diagonal(Kbar, off).to(torch.float32), DIAG_CORRECTION_BLOCK,
            xcols32=ctx.xi32)
        return pbar.to(p.dtype), None, None, None, None


def _chunked_gram_pullback(model, p32, xi32, kbar_rows, diag_bar, chunk, xcols32=None):
    """grad_p <Kbar, K(p)> for the f32 gram K(p) = cross_cov(xi, xcols, p) +
    the diagonal correction at xi's points (xcols defaults to xi; a row slab
    of the gram passes its rows as xi and all the points as xcols), by row
    chunks: ``kbar_rows(r0, r1)`` gives Kbar[r0:r1] in f32 (a slice of a
    held Kbar, or formed on the fly by the streamed engine), ``diag_bar`` its
    f32 entries at the correction's places.  Each chunk's gradient goes
    through the f32 kernel chain (residuals of one chunk only; K1d/K1m f32
    backward on the card) and is accumulated in f64, with the
    diagonal-correction term."""
    n = xi32.shape[0]
    xc = (xi32 if xcols32 is None else xcols32).clone()  # defeats the kernel's `y is x`
    g = torch.zeros(p32.shape, dtype=torch.float64, device=p32.device)
    with torch.enable_grad():
        pv = p32.detach().requires_grad_(True)
        for r0 in range(0, n, chunk):
            kb = kbar_rows(r0, min(n, r0 + chunk))
            Kr = model.covariance(xi32[r0:r0 + chunk], xc, pv)
            (gc,) = torch.autograd.grad(torch.sum(kb * Kr.to(kb.dtype)), pv)
            g += gc.double()
        corr = _diag_correction(model, pv, xi32)
        (gd,) = torch.autograd.grad(torch.sum(diag_bar * corr.to(diag_bar.dtype)), pv)
    return g + gd.double()


def _make_cov(model, covparam, xi, mesh, axis_name):
    """covparam -> K for the resident branch: the f32-backward gram on the
    mixed engine (f32-polymorphic kernel), else the checkpointed f64 gram."""
    from .streamed import kernel_is_f32_polymorphic

    if chol_engine(xi.shape[0]) == "mixed" and xi.dtype == torch.float64:
        if kernel_is_f32_polymorphic(model, covparam, xi):
            xi32 = xi.to(torch.float32)
            return lambda p: _CovF32Backward.apply(p, model, xi, xi32, mesh)
    return lambda p: checkpoint(
        lambda q: sharded_covariance(model, q, xi, mesh, axis_name=axis_name), p,
        use_reentrant=False)


def _solve_and_logdet(model, covparam, xi, rhs, mesh, axis_name, block, factor):
    """(K^{-1} rhs, log det K): rhs and the solution are this rank's row slabs
    on a group mesh, log det replicated."""
    if factor is None and _streamed_active(model, covparam, xi, mesh, axis_name):
        # past the resident engines' memory: K is streamed from the kernel
        from .streamed import streamed_mp_solve_and_logdet

        return streamed_mp_solve_and_logdet(model, covparam, xi, rhs)
    if factor is None:
        K = _make_cov(model, covparam, xi, mesh, axis_name)(covparam)
    else:
        K = factor  # the factored solve never reads K
    return _engine_solve_and_logdet(K, rhs, mesh, axis_name, block, factor=factor)


def sharded_negative_log_restricted_likelihood(
    model, covparam, xi, zi, mesh, axis_name="shard", block=256, factor=None
):
    """Profiled REML on the mesh.

    Same value as core.likelihood.negative_log_restricted_likelihood
    (impl='profiled'); differentiable end to end.  ``block``: the blocked
    factor's panel size (n must be divisible by it on the resident branch).
    ``factor``: a blocked Cholesky factor of THE COVARIANCE AT covparam
    (sharded_cholesky's L; its row slab on a group mesh) -- skips the
    O(n^3) refactorization; VALUE ONLY: differentiating with respect to
    covparam raises.  On a group mesh the inputs and the value are
    replicated."""
    covparam = gnp.asarray(covparam)
    Pd = model.mean(xi, model.meanparam)
    n, q = Pd.shape
    z_loc, P_loc = comm.slab(zi, mesh), comm.slab(Pd, mesh)
    rhs = torch.cat([z_loc.reshape(-1, 1), P_loc], dim=1)
    X, ldetK = _solve_and_logdet(model, comm.replicate(covparam, mesh), xi, rhs, mesh,
                                 axis_name, block, factor)
    Kinv_z = X[:, 0]
    Kinv_P = X[:, 1:]
    M = comm.psum(P_loc.T @ Kinv_P, mesh)
    Cm = gnp.cholesky(M)
    b = comm.psum(P_loc.T @ Kinv_z, mesh)
    u = gnp.solve_triangular(Cm, b, lower=True)
    quad = comm.psum(z_loc @ Kinv_z, mesh) - u @ u
    ldetM = 2.0 * torch.sum(torch.log(torch.diagonal(Cm)))
    ldetPtP = gnp.logdet(Pd.T @ Pd)
    L = 0.5 * ((n - q) * log(2.0 * pi) + ldetK + ldetM - ldetPtP + quad)
    out = _nan_to_inf(L.reshape(()))
    if factor is not None:
        # covparam never enters the factored graph: its gradient would
        # silently be zero
        out = value_only_wrt(out, covparam)
    return out


def sharded_negative_log_likelihood_zero_mean(
    model, covparam, xi, zi, mesh, axis_name="shard", block=256
):
    """Zero-mean NLL on the mesh (the engines as above; replicated inputs
    and value on a group mesh)."""
    n = xi.shape[0]
    z_loc = comm.slab(zi, mesh)
    Kinv_z, ldetK = _solve_and_logdet(model, comm.replicate(gnp.asarray(covparam), mesh), xi,
                                      z_loc, mesh, axis_name, block, None)
    L = 0.5 * (n * log(2.0 * pi) + ldetK + comm.psum(z_loc @ Kinv_z, mesh))
    return _nan_to_inf(L.reshape(()))
