# gpmp_tpu_torch/parallel/likelihood.py
"""Large-n GP selection criteria on a one-card mesh.

Counterpart of gpmp_tpu/parallel/likelihood.py, single-card parts: the same
profiled REML and zero-mean NLL as gpmp_tpu_torch.core.likelihood, with
K^{-1} [z P] and log det K from the streamed engine (parallel/streamed.py),
which never holds the (n, n) covariance in float64.

The model kernel is called as cross-covariance (x_rows, x_full), which
skips its ``y is x`` self-branch; the self-vs-cross diagonal difference
(noise variance + nugget) is measured once per covparam from the full
kernel (``_diag_correction``) and added back on the diagonal.

Not ported yet: the resident branch (the f64 gram handed to the sharded
mixed engine or to the blocked Cholesky, gpmp_tpu/parallel/mixed.py and
chol.py, K8/K9) with its panel size ``block=``, ``factor=``, and meshes of
more than one card.  They raise
NotImplementedError; the resident branch does not fall back to the core
engines, which run another algorithm.
"""

from math import log, pi

import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.core.likelihood import _nan_to_inf

# Points per block of _diag_correction.  Only the block diagonals are read,
# so the size is free: each block costs two host calls of the kernel (two
# K1d/K1m launches each on the card) and block^2 kernel entries.  512 makes
# n = 32768 cost 64 pairs of gram calls (1.7e7 entries, a few ms on the
# card); the JAX package's 32, which XLA vmaps into one program, would be
# 2048 pairs of host calls here.
DIAG_CORRECTION_BLOCK = 512


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported yet: it needs the blocked Cholesky and the refined "
        "panels of the next slice (K8/K9: parallel/chol.py, parallel/mixed.py; "
        "ROADMAP queue 1 item 11)")


def _check_one_card(mesh):
    if mesh is not None and mesh.size != 1:
        raise NotImplementedError(
            "meshes of more than one card need torch.distributed/NCCL "
            "(ROADMAP queue 1 item 11)")


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
    """The (n, n) covariance with the self-branch diagonal, on one card:
    the cross-covariance plus the measured diagonal correction."""
    _check_one_card(mesh)
    corr = _diag_correction(model, covparam, xi)
    Kl = model.covariance(xi, xi.clone(), covparam)
    return Kl + torch.diag(corr.to(Kl.dtype))


def _streamed_active(model, covparam, xi, mesh, axis_name):
    """True when the criterion runs on the streamed engine: n past the
    resident engines' memory wall (or GPMP_STREAM_N), mixed engine
    configured, f32-polymorphic kernel."""
    from .streamed import streamed_applicable

    try:
        return streamed_applicable(model, covparam, xi, mesh, axis_name)
    except Exception:
        return False


def _streamed_solve_and_logdet(model, covparam, xi, rhs, mesh, axis_name, block, factor=None):
    if factor is not None:
        _not_ported("factor= (a precomputed distributed Cholesky factor)")
    if block is not None:
        _not_ported("block= (the resident branch's panel size)")
    _check_one_card(mesh)
    if not _streamed_active(model, covparam, xi, mesh, axis_name):
        _not_ported("the resident mesh branch (n below the streamed engine's cutover, "
                    "or the f64 engine)")
    from .streamed import streamed_mp_solve_and_logdet

    return streamed_mp_solve_and_logdet(model, covparam, xi, rhs)


def sharded_negative_log_restricted_likelihood(
    model, covparam, xi, zi, mesh, axis_name="shard", block=None, factor=None
):
    """Profiled REML on the mesh's card, K streamed from the kernel.

    Same value as core.likelihood.negative_log_restricted_likelihood
    (impl='profiled'); differentiable through the streamed engine's analytic
    backward.  ``block``, the resident branch's panel size, and ``factor``
    raise NotImplementedError until that branch is ported."""
    Pd = model.mean(xi, model.meanparam)
    n, q = Pd.shape
    rhs = torch.cat([zi.reshape(-1, 1), Pd], dim=1)
    X, ldetK = _streamed_solve_and_logdet(model, covparam, xi, rhs, mesh, axis_name, block,
                                          factor)
    Kinv_z = X[:, 0]
    Kinv_P = X[:, 1:]
    M = Pd.T @ Kinv_P
    Cm = gnp.cholesky(M)
    b = Pd.T @ Kinv_z
    u = gnp.solve_triangular(Cm, b, lower=True)
    quad = zi @ Kinv_z - u @ u
    ldetM = 2.0 * torch.sum(torch.log(torch.diagonal(Cm)))
    ldetPtP = gnp.logdet(Pd.T @ Pd)
    L = 0.5 * ((n - q) * log(2.0 * pi) + ldetK + ldetM - ldetPtP + quad)
    return _nan_to_inf(L.reshape(()))


def sharded_negative_log_likelihood_zero_mean(
    model, covparam, xi, zi, mesh, axis_name="shard", block=None
):
    """Zero-mean NLL on the mesh's card, K streamed from the kernel."""
    n = xi.shape[0]
    Kinv_z, ldetK = _streamed_solve_and_logdet(model, covparam, xi, zi, mesh, axis_name, block)
    L = 0.5 * (n * log(2.0 * pi) + ldetK + zi @ Kinv_z)
    return _nan_to_inf(L.reshape(()))
