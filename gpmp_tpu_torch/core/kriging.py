# gpmp_tpu_torch/core/kriging.py
"""Kriging predictors and posterior variances.

Counterpart of gpmp_tpu/core/kriging.py.  Universal kriging defaults to
the Schur-complement route ('spd_schur', Cholesky solves of K only); the
CPD-safe 'nullspace' route and the saddle-point 'block' system (QR solve,
no LU) are kept for cross-checking.
"""

import torch

import gpmp_tpu_torch.num as gnp
from .linalg import _dot0, engine_cholesky_solve, qr_nullspace


def kriging_predictor_with_zero_mean(model, xi, xt, return_type=0):
    """Simple kriging weights and posterior variance (zero prior mean)."""
    Kii = model.covariance(xi, xi, model.covparam)
    Kit = model.covariance(xi, xt, model.covparam)
    lambda_t = engine_cholesky_solve(Kii, Kit)
    zt_posterior_variance = _compute_posterior_variance(
        model, xt, lambda_t, Kit, return_type
    )
    return lambda_t, zt_posterior_variance


def kriging_predictor(model, xi, xt, return_type=0, method="spd_schur"):
    """Universal kriging weights and posterior variance (linear predictor
    mean).

    method='spd_schur' (default): Schur-complement solution of the
    saddle-point system using Cholesky solves of K only --
      mu     = (P'K^{-1}P)^{-1} (P'K^{-1}K_it - P_t')
      lambda = K^{-1}(K_it - P mu)
    Valid whenever K is PD (always true for kernels with a nugget).

    method='nullspace': CPD-safe contrast-space computation.
    """
    if method == "nullspace":
        return _kriging_predictor_nullspace(model, xi, xt, return_type)
    return _kriging_predictor_spd_schur(model, xi, xt, return_type)


def _kriging_predictor_spd_schur(model, xi, xt, return_type=0):
    K = model.covariance(xi, xi, model.covparam)
    P = model.mean(xi, model.meanparam)
    Kit = model.covariance(xi, xt, model.covparam)
    Pt = model.mean(xt, model.meanparam)

    rhs = torch.cat([Kit, P], dim=1)
    X = engine_cholesky_solve(K, rhs)
    Kinv_Kit = X[:, : Kit.shape[1]]
    Kinv_P = X[:, Kit.shape[1]:]

    M = P.T @ Kinv_P  # (q, q) SPD
    Cm = gnp.cholesky(M)
    resid = P.T @ Kinv_Kit - Pt.T
    mu = gnp.solve_triangular(
        Cm.T, gnp.solve_triangular(Cm, resid, lower=True), lower=False
    )
    lambda_t = Kinv_Kit - Kinv_P @ mu

    lambdamu_t = torch.cat([lambda_t, mu], dim=0)
    RHS = torch.cat([Kit, Pt.T], dim=0)
    zt_posterior_variance = _compute_posterior_variance(
        model, xt, lambdamu_t, RHS, return_type
    )
    return lambda_t, zt_posterior_variance


def kriging_predictor_block(model, xi, xt, return_type=0):
    """Universal kriging via the saddle-point block system
    [[K, P], [P^T, 0]] [lambda; mu] = [K_it; P_t^T], solved by QR."""
    Kii = model.covariance(xi, xi, model.covparam)
    Pi = model.mean(xi, model.meanparam)
    ni, q = Pi.shape
    zeros = torch.zeros((q, q), dtype=Kii.dtype, device=Kii.device)
    LHS = torch.cat(
        (torch.cat((Kii, Pi), dim=1), torch.cat((Pi.T, zeros), dim=1)), dim=0
    )
    Kit = model.covariance(xi, xt, model.covparam)
    Pt = model.mean(xt, model.meanparam)
    RHS = torch.cat((Kit, Pt.T), dim=0)
    lambdamu_t = gnp.solve(LHS, RHS)
    lambda_t = lambdamu_t[0:ni, :]
    zt_posterior_variance = _compute_posterior_variance(
        model, xt, lambdamu_t, RHS, return_type
    )
    return lambda_t, zt_posterior_variance


def select_predictor(model, xi, zi, xt):
    """Dispatch on model.meantype; returns (zi_centered, zt_prior_mean,
    lambda_t, zt_posterior_variance)."""
    zt_prior_mean = 0.0
    zi_centered = zi

    if model.meantype == "zero":
        lambda_t, zt_posterior_variance = kriging_predictor_with_zero_mean(
            model, xi, xt, return_type=0
        )
    elif model.meantype == "linear_predictor":
        lambda_t, zt_posterior_variance = kriging_predictor(
            model, xi, xt, return_type=0
        )
    elif model.meantype == "parameterized":
        if model.meanparam is None:
            raise ValueError(
                "For meantype 'parameterized', meanparam should not be None."
            )
        lambda_t, zt_posterior_variance = kriging_predictor_with_zero_mean(
            model, xi, xt, return_type=0
        )
        zi_prior_mean = model.mean(xi, model.meanparam).reshape(-1)
        zi_centered = zi - zi_prior_mean
        zt_prior_mean = model.mean(xt, model.meanparam).reshape(-1)
    else:
        raise ValueError(
            f"Invalid meantype {model.meantype}. "
            "Supported types are 'zero', 'parameterized', and 'linear_predictor'."
        )

    return zi_centered, zt_prior_mean, lambda_t, zt_posterior_variance


def _compute_posterior_variance(model, xt, lambdamu_t, RHS, return_type=0):
    """Posterior variance: prior variance minus explained part."""
    if return_type == -1:
        return None
    elif return_type == 0:
        zt_prior_variance = model.covariance(xt, None, model.covparam, pairwise=True)
        return zt_prior_variance - _dot0(lambdamu_t, RHS)
    elif return_type == 1:
        zt_prior_variance = model.covariance(xt, None, model.covparam, pairwise=False)
        return zt_prior_variance - lambdamu_t.T @ RHS
    else:
        raise ValueError("return_type must be in {-1, 0, 1}")


def _kriging_predictor_nullspace(model, xi, xt, return_type=0):
    """CPD-safe universal kriging in contrast space (Null(P^T) basis).

    With [Q1 | W] from a complete QR of P:
      beta  = R_q^{-T} P_t^T                  (unbiasedness P^T lambda = P_t^T)
      alpha = G^{-1} W^T (K_it - K Q1 beta)   (G = W^T K W SPD)
      mu    = R_q^{-1} Q1^T (K_it - K lambda) (Lagrange multiplier)
    """
    K = model.covariance(xi, xi, model.covparam)
    P = model.mean(xi, model.meanparam)
    Kit = model.covariance(xi, xt, model.covparam)
    Pt = model.mean(xt, model.meanparam)

    Q1, W, Rq = qr_nullspace(P)

    G = W.T @ (K @ W)

    beta = gnp.solve_triangular(Rq.T, Pt.T, lower=True)  # (q, m)
    Q1beta = Q1 @ beta  # (n, m)
    resid = Kit - K @ Q1beta
    alpha, _ = gnp.cholesky_solve(G, W.T @ resid)

    lambda_t = W @ alpha + Q1beta

    if return_type == -1:
        return lambda_t, None

    mu = gnp.solve_triangular(Rq, Q1.T @ (Kit - K @ lambda_t), lower=False)
    RHS = torch.cat((Kit, Pt.T), dim=0)
    LM = torch.cat((lambda_t, mu), dim=0)
    if return_type == 0:
        v0 = model.covariance(xt, xt, model.covparam, pairwise=True)
        zt_posterior_variance = v0 - _dot0(LM, RHS)
    elif return_type == 1:
        V0 = model.covariance(xt, xt, model.covparam, pairwise=False)
        zt_posterior_variance = V0 - LM.T @ RHS
    else:
        raise ValueError("return_type must be in {-1,0,1}")

    return lambda_t, zt_posterior_variance
