# gpmp_tpu_torch/core/linalg.py
"""Linear-algebra helpers shared across gpmp_tpu_torch.core.

Counterpart of gpmp_tpu/core/linalg.py with the exact f64 engine only:
the Cholesky factorization and triangular solves go to ``torch.linalg``
(cuSOLVER/cuBLAS on the card).  The 'mixed' engine is not ported
(config.set_chol_engine('mixed') raises).
"""

import torch

import gpmp_tpu_torch.num as gnp


def _dot0(a, b):
    """sum_i a[i, ...] * b[i, ...] (the JAX package's einsum 'i..., i...')."""
    return torch.sum(a * b, dim=0)


def solve_and_logdet(K, rhs):
    """(K^{-1} rhs, log det K) via Cholesky; NaN-propagating."""
    X, C = gnp.cholesky_solve(K, rhs)
    return X, 2.0 * torch.sum(torch.log(torch.diagonal(C)))


def engine_cholesky_solve(K, rhs):
    """K^{-1} rhs via Cholesky (no logdet)."""
    X, _C = gnp.cholesky_solve(K, rhs)
    return X


def diag_Kinv_from_chol(C, lower: bool = True):
    """diag(K^{-1}) from a Cholesky factor C of K.

    With K = C C^T (C lower), K^{-1} = C^{-T} C^{-1}; letting T = C^{-1},
    diag(K^{-1}) is the columnwise sum of squares of T.
    """
    n = C.shape[0]
    T = gnp.solve_triangular(C, torch.eye(n, dtype=C.dtype, device=C.device),
                             lower=lower)
    return torch.sum(T * T, dim=0 if lower else 1)


def compute_contrast_matrix(P):
    """W whose columns span Null(P^T), from a complete QR of P.

    torch.linalg.qr(mode='complete') has no backward when n > q: use it
    for values only (the 'contrast' REML is tested for value only).
    """
    n, q = P.shape
    Q, _R = gnp.qr(P, mode="complete")
    return Q[:, q:n]


def compute_contrast_covariance(W, K):
    """G = W^T (K W): covariance of the contrasts W^T z for z ~ N(0, K)."""
    return W.T @ (K @ W)


def qr_nullspace(P):
    """(Q1, W, Rq): Col(P) basis, Null(P^T) basis, leading R block."""
    Q, R = gnp.qr(P, mode="complete")
    q = P.shape[1]
    return Q[:, :q], Q[:, q:], R[:q, :q]


def norm_k_sqrd_with_zero_mean(model, xi, zi, covparam):
    """z^T K^{-1} z for zero-mean models."""
    K = model.covariance(xi, xi, covparam)
    Kinv_zi = engine_cholesky_solve(K, zi)
    return _dot0(zi, Kinv_zi)


def k_inverses(model, xi, zi, covparam):
    """(z^T K^{-1} z, K^{-1} 1, K^{-1} z) via one Cholesky."""
    K = model.covariance(xi, xi, covparam)
    zi_col = zi.reshape(-1, 1)
    rhs = torch.cat([zi_col, torch.ones_like(zi_col)], dim=1)
    sol = engine_cholesky_solve(K, rhs)
    Kinv_zi = sol[:, 0].reshape(zi.shape)
    Kinv_1 = sol[:, 1].reshape(zi.shape)
    return _dot0(zi, Kinv_zi), Kinv_1, Kinv_zi


def norm_k_sqrd(model, xi, zi, covparam):
    """(Wz)^T (W^T K W)^{-1} (Wz) for linear_predictor models (CPD-safe
    contrast formulation)."""
    K = model.covariance(xi, xi, covparam)
    P = model.mean(xi, model.meanparam)
    W = compute_contrast_matrix(P)
    Wzi = W.T @ zi
    G = compute_contrast_covariance(W, K)
    WKWinv_Wzi, _ = gnp.cholesky_solve(G, Wzi)
    return _dot0(Wzi, WKWinv_Wzi)
