# gpmp_tpu_torch/parallel/loo.py
"""Large-n leave-one-out (virtual) cross-validation on a mesh.

Counterpart of gpmp_tpu/parallel/loo.py: the results of core/loo.py with
the n x n work through the blocked Cholesky with refined panels
(parallel/chol.py; the factor overwrites the covariance's buffer where no
gradient is asked).  For the linear-predictor mean the projected-precision
identity is used instead of the contrast-space QR (equivalent for PD K):

  Q^{-1}       = K^{-1} - B Mq^{-1} B',   B = K^{-1} P,  Mq = P' K^{-1} P
  e_i          = (Q^{-1} z)_i / (Q^{-1})_ii
  sigma2_loo,i = 1 / (Q^{-1})_ii

diag(K^{-1}) comes from the explicit triangular inverse M = L^{-1} (one
blocked solve with an identity right-hand side): diag(K^{-1})_i =
sum_k M[k, i]^2, the column sums of squares.

On a group mesh each rank factors its row slab and solves on slabs; the
column sums of squares of M's slabs are all-reduced and K^{-1} [z P] is
gathered, so the inputs and the (n,) results are replicated on every rank.
"""

import torch

import gpmp_tpu_torch.num as gnp
from . import comm
from .chol import _factor_in_place, blocked_solve_lower, blocked_solve_upper_t
from .likelihood import sharded_covariance


def sharded_loo(model, xi, zi, mesh, axis_name="shard", block=256):
    """(zloo, sigma2loo, eloo) with the covariance factored on the mesh
    (replicated inputs and results on a group mesh)."""
    model = model._bound()  # the parameters as tensors
    xi = gnp.asarray(xi)
    zi = gnp.asarray(zi).reshape(-1)

    if model.meantype == "zero":
        return _sharded_loo_zero_mean(model, xi, zi, mesh, axis_name, block)
    if model.meantype == "parameterized":
        zi_prior_mean = model.mean(xi, model.meanparam).reshape(-1)
        zloo_c, sigma2loo, eloo = _sharded_loo_zero_mean(
            model, xi, zi - zi_prior_mean, mesh, axis_name, block)
        return zloo_c + zi_prior_mean, sigma2loo, eloo
    if model.meantype == "linear_predictor":
        return _sharded_loo_linear_predictor(model, xi, zi, mesh, axis_name, block)
    raise ValueError(f"Invalid meantype {model.meantype}.")


def _sharded_kinv_parts(model, xi, zi, mesh, axis_name, block, extra_rhs=None):
    """(K^{-1} [z | extra], diag(K^{-1})) via the blocked factor (both
    replicated on a group mesh)."""
    n = xi.shape[0]
    L = _factor_in_place(sharded_covariance(model, model.covparam, xi, mesh,
                                            axis_name=axis_name), mesh, block)
    rhs = zi.reshape(-1, 1)
    if extra_rhs is not None:
        rhs = torch.cat([rhs, extra_rhs], dim=1)
    off, n_loc = comm.rows_of(n, mesh)
    eye = torch.zeros((n_loc, n), dtype=L.dtype, device=L.device)
    eye.diagonal(off).fill_(1.0)  # this rank's rows of the identity
    y = blocked_solve_lower(L, comm.slab(rhs, mesh), block=block, mesh=mesh)
    X = blocked_solve_upper_t(L, y, block=block, mesh=mesh)
    M = blocked_solve_lower(L, eye, block=block, mesh=mesh)
    del L, eye
    diag_kinv = torch.einsum("ki,ki->i", M, M)
    return comm.gather_rows(X, mesh), comm.all_reduce_sum_(diag_kinv, mesh)


def _sharded_loo_zero_mean(model, xi, zi, mesh, axis_name, block):
    X, diag_kinv = _sharded_kinv_parts(model, xi, zi, mesh, axis_name, block)
    eloo = X[:, 0] / diag_kinv
    return zi - eloo, 1.0 / diag_kinv, eloo


def _sharded_loo_linear_predictor(model, xi, zi, mesh, axis_name, block):
    P = model.mean(xi, model.meanparam)
    X, diag_kinv = _sharded_kinv_parts(model, xi, zi, mesh, axis_name, block, extra_rhs=P)
    kinv_z = X[:, 0]
    B = X[:, 1:]  # K^{-1} P, (n, q)
    Cm = gnp.cholesky(P.T @ B)
    # V = Mq^{-1} B' -> (q, n); diag(Q^{-1}) = diag(K^{-1}) - sum_j B V'
    V = gnp.solve_triangular(Cm.T, gnp.solve_triangular(Cm, B.T, lower=True), lower=False)
    diag_q = diag_kinv - torch.einsum("iq,qi->i", B, V)
    eloo = (kinv_z - B @ (V @ zi)) / diag_q
    return zi - eloo, 1.0 / diag_q, eloo
