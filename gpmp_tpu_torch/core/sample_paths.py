# gpmp_tpu_torch/core/sample_paths.py
"""GP sample paths: unconditional draws, and conditioning by kriging.

Counterpart of gpmp_tpu/core/sample_paths.py.  Draws come from
``gnp.randn`` (the module-level generator, ``gnp.set_seed``), or from an
explicit ``generator=`` where the JAX package takes ``key=``.

The square root C of K (paths = C eps):

- ``method="chol"``: the f64 engine's Cholesky factor; on the mixed engine
  (n >= 192, ``core.linalg.chol_engine``) the sampling root
  ``ops.refine.sampling_sqrt`` (K5, K8s), and when that is NaN (cond(K)
  beyond the f32 range) the f64 factor after all, on the same device: the
  reference's rule.  ``BRANCHES`` counts which one each call took.
- ``method="svd"``: the symmetric root Q diag(sign(l) sqrt|l|) Q^T from
  ``torch.linalg.eigh``, which is what the JAX package's
  ``svd(hermitian=True)`` gives, and unique.
"""

import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.ops import refine

from .linalg import chol_engine

# calls by the factor they used: "cholesky" (f64 engine), "sampling_sqrt"
# (mixed engine), "fallback" (mixed engine, NaN root, then the f64 factor), "svd"
BRANCHES = {"cholesky": 0, "sampling_sqrt": 0, "fallback": 0, "svd": 0}


def sampling_factor(K, method="chol", check_result=True):
    """C with C C^T = K: the factor ``sample_paths`` draws with."""
    if method == "chol":
        if chol_engine(K.shape[0]) == "mixed":
            C = refine.sampling_sqrt(K)
            # one host read, as in the reference
            if not bool(torch.isnan(C).any()):
                BRANCHES["sampling_sqrt"] += 1
                return C
            BRANCHES["fallback"] += 1
        else:
            BRANCHES["cholesky"] += 1
        C = gnp.cholesky(K)
        if check_result and bool(torch.isnan(C).any()):
            raise AssertionError(
                "Cholesky factorization failed (NaNs). "
                "Consider adding jitter or use method='svd'."
            )
        return C
    if method == "svd":
        BRANCHES["svd"] += 1
        lam, Q = torch.linalg.eigh(K)
        return (Q * (torch.sign(lam) * torch.sqrt(torch.abs(lam)))) @ Q.T
    raise ValueError("method must be 'chol' or 'svd'")


def sample_paths(model, xt, nb_paths, method="chol", check_result=True, generator=None):
    """nb_paths draws from GP(0, k) on xt, as an (nt, nb_paths) tensor;
    factorization 'chol' or 'svd'."""
    xt_ = gnp.asarray(xt)
    K = model.covariance(xt_, xt_, model.covparam)
    C = sampling_factor(K, method, check_result)
    if generator is None:
        eps = gnp.randn(K.shape[0], nb_paths)
    else:
        eps = torch.randn((K.shape[0], nb_paths), generator=generator, dtype=K.dtype,
                          device=K.device)
    return C @ eps


def _indices(ind):
    return gnp.asarray(ind, dtype=torch.int64).reshape(-1)


def conditional_sample_paths(model, ztsim, xi_ind, zi, xt_ind, lambda_t, convert_out=True):
    """Conditioning by kriging: ztsimc = ztsim[xt] + lambda' (zi - ztsim[xi])."""
    zi_ = gnp.asarray(zi).reshape(-1, 1)
    ztsim_ = gnp.asarray(ztsim)
    delta = zi_ - ztsim_[_indices(xi_ind), :]
    ztsimc = ztsim_[_indices(xt_ind), :] + gnp.asarray(lambda_t).T @ delta
    return gnp.to_np(ztsimc) if convert_out else ztsimc


def conditional_sample_paths_parameterized_mean(
    model, ztsim, xi, xi_ind, zi, xt, xt_ind, lambda_t, convert_out=True
):
    """Conditioning with a parameterized mean: center, condition, re-add."""
    xi_, zi_, xt_ = gnp.asarray(xi), gnp.asarray(zi), gnp.asarray(xt)
    ztsim_ = gnp.asarray(ztsim)
    zi_centered = zi_ - model.mean(xi_, model.meanparam).reshape(-1)
    zt_prior_mean = model.mean(xt_, model.meanparam).reshape(-1, 1)
    delta = zi_centered.reshape(-1, 1) - ztsim_[_indices(xi_ind), :]
    ztsimc = (ztsim_[_indices(xt_ind), :] + gnp.asarray(lambda_t).T @ delta
              + zt_prior_mean)
    return gnp.to_np(ztsimc) if convert_out else ztsimc
