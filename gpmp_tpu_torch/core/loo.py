# gpmp_tpu_torch/core/loo.py
"""Leave-one-out (virtual cross-validation) predictions.

Counterpart of gpmp_tpu/core/loo.py: zero mean, parameterized mean, and
the linear-predictor mean, with its CPD-safe contrast formulation on the
f64 engine and the profiled projector on the mixed engine.
"""

import torch

import gpmp_tpu_torch.num as gnp
from .linalg import _engine_for, engine_solve_and_inv_diag


def loo(model, xi, zi):
    """LOO predictions/variances/errors for the model's meantype."""
    if model.meantype == "zero":
        return _loo_with_zero_mean(model, model.covparam, xi, zi)
    elif model.meantype == "parameterized":
        return _loo_with_parameterized_mean(
            model, model.meanparam, model.covparam, xi, zi
        )
    elif model.meantype == "linear_predictor":
        return _loo_with_linear_predictor_mean_cpd(
            model, model.meanparam, model.covparam, xi, zi
        )
    else:
        raise ValueError(f"Unknown mean type: {model.meantype}")


def _loo_with_zero_mean(model, covparam, xi, zi):
    """e_i = (K^{-1} z)_i / (K^{-1})_ii ; sigma2_i = 1/(K^{-1})_ii."""
    K = model.covariance(xi, xi, covparam)
    Kinv_zi, Kinvdiag = engine_solve_and_inv_diag(K, zi)
    eloo = Kinv_zi.reshape(-1) / Kinvdiag
    sigma2loo = 1.0 / Kinvdiag
    zloo = zi - eloo
    return zloo, sigma2loo, eloo


def _loo_with_parameterized_mean(model, meanparam, covparam, xi, zi):
    zi_prior_mean = model.mean(xi, meanparam).reshape(-1)
    centered_zi = zi - zi_prior_mean
    zloo_centered, sigma2loo, eloo_centered = _loo_with_zero_mean(
        model, covparam, xi, centered_zi
    )
    zloo = zloo_centered + zi_prior_mean
    return zloo, sigma2loo, eloo_centered


def _loo_with_linear_predictor_mean_cpd(model, meanparam, covparam, xi, zi):
    """Contrast-space LOO: Qinv = W (W'KW)^{-1} W'; CPD-safe.

    Under the mixed engine K must be PD anyway, so the complete n x n QR
    and contrast solve are replaced by the profiled projector identity
    Qinv = K^{-1} - K^{-1}P (P'K^{-1}P)^{-1} P'K^{-1}: one engine solve
    with (1+q) right-hand sides plus O(nq^2) work.
    """
    K = model.covariance(xi, xi, covparam)
    P = model.mean(xi, meanparam)

    if _engine_for(K) == "mixed":
        rhs = torch.cat([zi.reshape(-1, 1), P], dim=1)
        A, diagKinv = engine_solve_and_inv_diag(K, rhs)
        a, U = A[:, 0], A[:, 1:]  # K^{-1}z, K^{-1}P
        Fc = gnp.cholesky(P.T @ U)  # (q, q), PD for full-rank P
        T = gnp.solve_triangular(Fc, U.T, lower=True)  # (q, n)
        Qinvdiag = diagKinv - torch.sum(T * T, dim=0)
        Pta = P.T @ a.reshape(-1, 1)
        w = gnp.solve_triangular(
            Fc.T, gnp.solve_triangular(Fc, Pta, lower=True), lower=False
        )
        Qinvzi = a - (U @ w).reshape(-1)
        eloo = Qinvzi / Qinvdiag
        sigma2loo = 1.0 / Qinvdiag
        zloo = zi - eloo
        return zloo, sigma2loo, eloo

    Q, _R = gnp.qr(P, mode="complete")
    W = Q[:, P.shape[1]:]
    G = W.T @ (K @ W)

    S, _ = gnp.cholesky_solve(G, W.T)  # G^{-1} W^T, (n-q, n)
    Qinvzi = W @ (S @ zi)
    Qinvdiag = torch.sum(W * S.T, dim=1)

    eloo = Qinvzi / Qinvdiag
    sigma2loo = 1.0 / Qinvdiag
    zloo = zi - eloo
    return zloo, sigma2loo, eloo
