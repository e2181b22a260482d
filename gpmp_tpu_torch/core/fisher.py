# gpmp_tpu_torch/core/fisher.py
"""Fisher information for covariance parameters.

Counterpart of gpmp_tpu/core/fisher.py (semantics of gpmp/core/fisher.py).
The covariance derivatives dK/dtheta_k come from autodiff, exactly: the
JAX package takes them by forward mode, and here they are p reverse passes
through the covariance's double backward (``_dK_stack``), which the gram
kernels' Functions have (ops/autograd.py).  ``epsilon`` is kept for the
API and used only by the finite-difference variant ``fisher_information_fd``.

``fisher_information`` given a covparam that requires grad (grad mode on)
returns a differentiable result: dK/dtheta keeps its graph, so its gradient
is a third derivative of the covariance, which the gram Functions give
through their plain composition (the reference prior
``kernel.priors.log_prior_reference`` differentiates it).  Otherwise the
result is computed without a graph.
"""

import numpy as np
import torch

import gpmp_tpu_torch.num as gnp
from .linalg import compute_contrast_matrix
from .utils import meanparam_of


def _dK_stack(model, xi, theta, create_graph=False):
    """dK/dtheta as a (p, n, n) stack; with ``create_graph`` it keeps its
    graph to ``theta`` (which then requires grad), else it is detached.

    The vjp g(V) = sum_ab V_ab dK_ab/dtheta is linear in the cotangent V, so
    the gradient of its k-th entry with respect to V is dK/dtheta_k: one
    reverse pass of the double backward per parameter, never a Jacobian
    over the n^2 entries of K.
    """
    if not create_graph:
        theta = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        K = model.covariance(xi, xi, theta)
        V = torch.zeros_like(K, requires_grad=True)
        (g,) = torch.autograd.grad(K, theta, V, create_graph=True)
        p = theta.shape[0]
        rows = []
        for k in range(p):
            (dK,) = torch.autograd.grad(g[k], V, retain_graph=create_graph or k < p - 1,
                                        create_graph=create_graph, allow_unused=True)
            rows.append(torch.zeros_like(K) if dK is None else dK)
    dK = torch.stack(rows)
    return dK if create_graph else dK.detach()


def _half_trace_products(F, dA):
    """0.5 Tr(A^{-1} dA_i A^{-1} dA_j) from A's Cholesky factor F."""
    S = gnp.solve_triangular(F.mT, gnp.solve_triangular(F, dA, lower=True), lower=False)
    return 0.5 * torch.einsum("iab,jba->ij", S, S)


def _theta(model, covparam):
    return gnp.asarray(model.covparam if covparam is None else covparam)


def fisher_information(model, xi, covparam=None, epsilon=1e-3):
    """I_ij = 0.5 Tr(K^{-1} dK_i K^{-1} dK_j) with exact autodiff dK."""
    theta, xi = _theta(model, covparam), gnp._tensor(xi)
    if torch.is_grad_enabled() and theta.requires_grad:
        K = model.covariance(xi, xi, theta)
        dK = _dK_stack(model, xi, theta, create_graph=True)
        return _half_trace_products(gnp.cholesky(K), dK)
    with torch.no_grad():
        K = model.covariance(xi, xi, theta)
    return _half_trace_products(gnp.cholesky(K), _dK_stack(model, xi, theta))


def fisher_information_cpd(model, xi, covparam=None, epsilon=1e-3):
    """Fisher information in contrast space G = W'KW when the mean is a
    linear predictor; the formula on K otherwise."""
    theta, xi = _theta(model, covparam), gnp._tensor(xi)
    if model.meantype != "linear_predictor":
        return fisher_information(model, xi, covparam=theta, epsilon=epsilon)
    with torch.no_grad():
        K = model.covariance(xi, xi, theta)
        W = compute_contrast_matrix(model.mean(xi, meanparam_of(model)))
        G = W.T @ (K @ W)
    dG = torch.einsum("ar,iab,bs->irs", W, _dK_stack(model, xi, theta), W)
    return _half_trace_products(gnp.cholesky(G), dG)


def fisher_information_torch(model, xi, covparam):
    """0.5 * the Hessian of log|K(theta)| (the name is the reference's)."""
    xi_ = gnp._tensor(xi)

    def log_det_cov(params):
        K = model.covariance(xi_, xi_, params)
        return 2.0 * torch.sum(torch.log(torch.diagonal(gnp.cholesky(K))))

    return 0.5 * torch.autograd.functional.hessian(log_det_cov, gnp.asarray(covparam))


def fisher_information_fd(model, xi, covparam=None, epsilon=1e-3):
    """Finite-difference variant (semantics of gpmp/core/fisher.py:18-78)."""
    theta = np.array(gnp.to_np(model.covparam if covparam is None else covparam),
                     dtype=float)
    xi = gnp._tensor(xi)
    p = theta.shape[0]
    with torch.no_grad():
        K = model.covariance(xi, xi, gnp.asarray(theta))
        K_inv = gnp.cholesky_inv(K)
        dK = []
        for i in range(p):
            def f(tmp_val, i=i):
                t = theta.copy()
                t[i] = tmp_val
                return model.covariance(xi, xi, gnp.asarray(t))
            dK.append(gnp.derivative_finite_diff(f, theta[i], epsilon))
        info = np.empty((p, p))
        for i in range(p):
            for j in range(i, p):
                term = 0.5 * torch.trace(K_inv @ dK[i] @ K_inv @ dK[j])
                info[i, j] = info[j, i] = float(term)
    return gnp.asarray(info)
