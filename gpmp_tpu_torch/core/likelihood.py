# gpmp_tpu_torch/core/likelihood.py
"""Negative (restricted) log-likelihoods, differentiable with torch.autograd.

Counterpart of gpmp_tpu/core/likelihood.py.  A non-PD covariance yields
NaNs from the Cholesky (no exception); the criterion then evaluates to
NaN, which is mapped to +inf.

REML has two implementations:
  * 'profiled' (default): the mean is profiled out analytically,
      L = 0.5 [ (n-q) log 2pi + log|K| + log|P'K^{-1}P| - log|P'P| + quad ],
    one n x n Cholesky and a triangular solve with (q+1) right-hand sides.
  * 'contrast': the contrast-space formula.  It goes through a complete
    QR, which torch cannot differentiate when n > q: use it for values.
"""

from math import log, pi

import torch

import gpmp_tpu_torch.num as gnp
from .linalg import (
    compute_contrast_covariance,
    compute_contrast_matrix,
    solve_and_logdet as _solve_and_logdet,
)


def _nan_to_inf(L):
    return torch.where(torch.isnan(L), torch.inf, L)


def negative_log_likelihood_zero_mean(model, covparam, xi, zi):
    """NLL of zi ~ N(0, K(covparam)); +inf if K is not PD."""
    K = model.covariance(xi, xi, covparam)
    n = K.shape[0]
    Kinv_zi, ldetK = _solve_and_logdet(K, zi)
    norm2 = torch.sum(zi * Kinv_zi)
    L = 0.5 * (n * log(2.0 * pi) + ldetK + norm2)
    return _nan_to_inf(L.reshape(()))


def negative_log_likelihood(model, meanparam, covparam, xi, zi):
    """NLL with a parameterized mean: center then zero-mean NLL."""
    zi_prior_mean = model.mean(xi, meanparam).reshape(-1)
    centered_zi = zi - zi_prior_mean
    return negative_log_likelihood_zero_mean(model, covparam, xi, centered_zi)


def _reml_profiled(model, covparam, xi, zi):
    """REML via analytic profiling of the linear-predictor mean."""
    K = model.covariance(xi, xi, covparam)
    P = model.mean(xi, model.meanparam)
    n, q = P.shape
    rhs = torch.cat([zi.reshape(-1, 1), P], dim=1)
    X, ldetK = _solve_and_logdet(K, rhs)  # K^{-1} [z P]
    Kinv_z = X[:, 0]
    Kinv_P = X[:, 1:]
    M = P.T @ Kinv_P  # P' K^{-1} P (q x q, tiny)
    Cm = gnp.cholesky(M)
    b = P.T @ Kinv_z
    u = gnp.solve_triangular(Cm, b, lower=True)
    quad = zi @ Kinv_z - u @ u
    ldetM = 2.0 * torch.sum(torch.log(torch.diagonal(Cm)))
    # P'P is SPD for a full-column-rank design; Cholesky logdet (LU-free)
    ldetPtP = gnp.logdet(P.T @ P)
    L = 0.5 * ((n - q) * log(2.0 * pi) + ldetK + ldetM - ldetPtP + quad)
    return _nan_to_inf(L.reshape(()))


def _reml_contrast(model, covparam, xi, zi):
    """REML in contrast space."""
    K = model.covariance(xi, xi, covparam)
    P = model.mean(xi, model.meanparam)
    W = compute_contrast_matrix(P)
    Wzi = W.T @ zi
    G = compute_contrast_covariance(W, K)
    WKWinv_Wzi, C = gnp.cholesky_solve(G, Wzi)
    norm2 = torch.sum(Wzi * WKWinv_Wzi)
    ldetWKW = 2.0 * torch.sum(torch.log(torch.diagonal(C)))
    n, q = P.shape
    L = 0.5 * ((n - q) * log(2.0 * pi) + ldetWKW + norm2)
    return _nan_to_inf(L.reshape(()))


def negative_log_restricted_likelihood(model, covparam, xi, zi, impl="profiled"):
    """Negative restricted (REML) log-likelihood.

    impl='profiled' (one Cholesky, differentiable) or 'contrast'
    (contrast-space formula, values only).
    """
    if impl == "profiled":
        return _reml_profiled(model, covparam, xi, zi)
    if impl == "contrast":
        return _reml_contrast(model, covparam, xi, zi)
    raise ValueError("impl must be 'profiled' or 'contrast'")
