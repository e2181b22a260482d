# gpmp_tpu_torch/core/linalg.py
"""Linear-algebra helpers shared across gpmp_tpu_torch.core.

Counterpart of gpmp_tpu/core/linalg.py.  The 'f64' engine (default) is
the exact Cholesky factorization and triangular solves of
``torch.linalg`` (cuSOLVER/cuBLAS on the card); the opt-in 'mixed' engine
(``config.set_chol_engine('mixed')``) is gpmp_tpu_torch.ops.mixed: an f32
factorization refined in f64 through the K3/K4/K5/K7/K7b kernels.
"""

import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.config import get_chol_engine
from gpmp_tpu_torch.ops import mixed

# below this size the f64 factorization is already cheap
_MIXED_MIN_N = 192


def _dot0(a, b):
    """sum_i a[i, ...] * b[i, ...] (the JAX package's einsum 'i..., i...')."""
    return torch.sum(a * b, dim=0)


def chol_engine(n=None):
    """Cholesky engine for SPD solves on the hot paths: 'f64' (default,
    also for 'auto') or 'mixed' (opt-in; close to f64 for moderate cond(K),
    less so near the f32 range: at cond(K) ~3e6 its predictions on the
    H100 are ~5e-4 from f64 (PERF.md); NaN -> +inf beyond ~1e7).  Given
    the problem size n, 'mixed' engages only for n >= 192."""
    eng = get_chol_engine()
    eng = "f64" if eng == "auto" else eng
    if eng == "mixed" and n is not None and n < _MIXED_MIN_N:
        return "f64"
    return eng


def _engine_for(K):
    return chol_engine(K.shape[0])


def solve_and_logdet(K, rhs):
    """(K^{-1} rhs, log det K) via the configured engine; NaN-propagating."""
    if _engine_for(K) == "mixed":
        return mixed.mp_solve_and_logdet(K, rhs)
    X, C = gnp.cholesky_solve(K, rhs)
    return X, 2.0 * torch.sum(torch.log(torch.diagonal(C)))


def engine_cholesky_solve(K, rhs):
    """K^{-1} rhs via the configured engine (no logdet)."""
    if _engine_for(K) == "mixed":
        return mixed.refined_solve(K, rhs)
    X, _C = gnp.cholesky_solve(K, rhs)
    return X


def engine_solve_and_inv_diag(K, rhs):
    """(K^{-1} rhs, diag(K^{-1})) via the configured engine: the mixed
    engine takes the diagonal from its series expansion
    (ops.mixed.mp_solve_and_inv_diag)."""
    if _engine_for(K) == "mixed":
        return mixed.mp_solve_and_inv_diag(K, rhs)
    X, C = gnp.cholesky_solve(K, rhs)
    return X, diag_Kinv_from_chol(C)


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
    """(Wz)^T (W^T K W)^{-1} (Wz) for linear_predictor models.

    Mixed engine: z^T Qinv z with Qinv = K^{-1} - K^{-1}P (P'K^{-1}P)^{-1}
    P'K^{-1} (K PD), from one engine solve with 1+q right-hand sides; the
    f64 path keeps the CPD-safe contrast formulation.
    """
    K = model.covariance(xi, xi, covparam)
    P = model.mean(xi, model.meanparam)
    if _engine_for(K) == "mixed":
        A = engine_cholesky_solve(K, torch.cat([zi.reshape(-1, 1), P], dim=1))
        a, U = A[:, 0], A[:, 1:]  # K^{-1}z, K^{-1}P
        Fc = gnp.cholesky(P.T @ U)
        w = gnp.solve_triangular(Fc, P.T @ a.reshape(-1, 1), lower=True)
        return (zi.reshape(-1) @ a - torch.sum(w * w)).reshape(())
    W = compute_contrast_matrix(P)
    Wzi = W.T @ zi
    G = compute_contrast_covariance(W, K)
    WKWinv_Wzi, _ = gnp.cholesky_solve(G, Wzi)
    return _dot0(Wzi, WKWinv_Wzi)
