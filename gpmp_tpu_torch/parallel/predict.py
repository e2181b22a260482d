# gpmp_tpu_torch/parallel/predict.py
"""Large-n GP prediction on a mesh.

Counterpart of gpmp_tpu/parallel/predict.py: the mathematics of
core/kriging.py in the spd_schur form, with the (n, n) training covariance
factored by the blocked Cholesky with refined panels (parallel/chol.py)
and solved by its blocked solves.  Where nothing differentiates through
the covariance, the factor overwrites the covariance's own buffer (one
(n, n) f64 buffer in all).  Dispatch on model.meantype as
core/kriging.select_predictor.

On a group mesh ``sharded_cross_covariance`` returns this rank's rows of
K(xi, xt); the other entry points take replicated inputs and return the same
replicated results on every rank: every sum over training rows is a
``comm.psum``, and the kriging weights and sample paths are gathered.
"""

import torch

import gpmp_tpu_torch.num as gnp
from . import comm
from .chol import (
    _factor_in_place,
    blocked_solve_lower,
    blocked_solve_upper_t,
    value_only_wrt,
)
from .likelihood import sharded_covariance


def sharded_cross_covariance(model, covparam, xi, xt, mesh, axis_name="shard"):
    """K(xi, xt) on the mesh (this rank's rows of it on a group mesh)."""
    return model.covariance(comm.slab(xi, mesh), xt, covparam)


def _ksolver(L, block, mesh):
    def ksolve(B):
        y = blocked_solve_lower(L, B, block=block, mesh=mesh)
        return blocked_solve_upper_t(L, y, block=block, mesh=mesh)

    return ksolve


def _universal_weights(model, xi, xt, Kit, ksolve, mesh):
    """(lambda, mu) of universal kriging, Schur-complement route (lambda's
    rows of this rank).  mu is replicated and this rank's terms consume it:
    it enters them through ``comm.replicate`` (see parallel/comm.py)."""
    Pd = comm.slab(model.mean(xi, model.meanparam), mesh)
    Pt = model.mean(xt, model.meanparam)
    X = ksolve(torch.cat([Kit, Pd], dim=1))
    Kinv_Kit = X[:, : Kit.shape[1]]
    Kinv_P = X[:, Kit.shape[1]:]
    Cm = gnp.cholesky(comm.psum(Pd.T @ Kinv_P, mesh))
    resid = comm.psum(Pd.T @ Kinv_Kit, mesh) - Pt.T
    mu = gnp.solve_triangular(Cm.T, gnp.solve_triangular(Cm, resid, lower=True), lower=False)
    return Kinv_Kit - Kinv_P @ comm.replicate(mu, mesh), mu, Pt


def sharded_kriging_weights(model, xi, xt, mesh, axis_name="shard", block=256):
    """Kriging weights lambda_t (n, nt) (replicated on a group mesh): feed
    these to core.sample_paths.conditional_sample_paths for large-n
    conditional simulation."""
    model = model._bound()  # the parameters as tensors
    xi = gnp.asarray(xi)
    xt = gnp.asarray(xt)
    covparam = model.covparam
    Kit = sharded_cross_covariance(model, covparam, xi, xt, mesh, axis_name=axis_name)
    L = _factor_in_place(sharded_covariance(model, covparam, xi, mesh, axis_name=axis_name),
                         mesh, block)
    ksolve = _ksolver(L, block, mesh)
    if model.meantype in ("zero", "parameterized"):
        return comm.gather_rows(ksolve(Kit), mesh)
    if model.meantype != "linear_predictor":
        raise ValueError(f"Invalid meantype {model.meantype}.")
    return comm.gather_rows(_universal_weights(model, xi, xt, Kit, ksolve, mesh)[0], mesh)


def sharded_sample_paths(model, xt, nb_paths, mesh, axis_name="shard", block=256,
                         generator=None):
    """nb_paths unconditional draws from GP(0, k) on xt, the (nt, nt)
    covariance factored by the blocked Cholesky; the normals from
    ``generator`` (a torch.Generator on xt's device) or gnp's own (rank 0's
    draws on a group mesh, broadcast; the paths are replicated)."""
    model = model._bound()
    xt = gnp.asarray(xt)
    L = _factor_in_place(sharded_covariance(model, model.covparam, xt, mesh,
                                            axis_name=axis_name), mesh, block)
    eps = gnp.randn(L.shape[1], nb_paths, generator=generator).to(L.dtype)
    return comm.gather_rows(L @ comm.broadcast_(eps.contiguous(), mesh), mesh)


def sharded_predict(model, xi, zi, xt, mesh, axis_name="shard", block=256,
                    convert_out=False, factor=None):
    """(zt_posterior_mean, zt_posterior_variance) with the training
    covariance factored by the blocked Cholesky on the mesh (replicated
    inputs and results on a group mesh).

    Matches model.predict for 'zero', 'parameterized' and 'linear_predictor'
    mean types.  factor: a previously computed blocked factor of the
    training covariance (sharded_cholesky's L; its row slab on a group
    mesh) -- predict after fit then costs only the blocked solves; a
    covparam gradient through it raises."""
    model = model._bound()
    xi = gnp.asarray(xi)
    zi = gnp.asarray(zi).reshape(-1)
    xt = gnp.asarray(xt)
    covparam = model.covparam
    if factor is not None:
        # the factorization's covparam-dependence is frozen in `factor`
        xi = value_only_wrt(xi, covparam)
    zt_prior_var = model.covariance(xt, None, covparam, pairwise=True)
    # the rank's own terms take covparam and xt through comm.replicate, the
    # replicated ones (the prior variance, the means) as they are: a
    # gradient in either then sums the ranks' parts once
    p_loc = comm.replicate(covparam, mesh)
    Kit = sharded_cross_covariance(model, p_loc, xi, comm.replicate(xt, mesh), mesh,
                                   axis_name=axis_name)
    if factor is None:
        L = _factor_in_place(sharded_covariance(model, p_loc, xi, mesh, axis_name=axis_name),
                             mesh, block)
    else:
        L = factor
    ksolve = _ksolver(L, block, mesh)

    if model.meantype in ("zero", "parameterized"):
        zi_c = zi
        zt_prior_mean = 0.0
        if model.meantype == "parameterized":
            zi_c = zi - model.mean(xi, model.meanparam).reshape(-1)
            zt_prior_mean = model.mean(xt, model.meanparam).reshape(-1)
        lam = ksolve(Kit)
        zpm = zt_prior_mean + comm.psum(torch.einsum("ij,i->j", lam, comm.slab(zi_c, mesh)), mesh)
        zpv = zt_prior_var - comm.psum(torch.einsum("ij,ij->j", lam, Kit), mesh)
        return _maybe_numpy(zpm, zpv, convert_out)

    if model.meantype != "linear_predictor":
        raise ValueError(f"Invalid meantype {model.meantype}.")
    lam, mu, Pt = _universal_weights(model, xi, xt, Kit, ksolve, mesh)
    zpm = comm.psum(torch.einsum("ij,i->j", lam, comm.slab(zi, mesh)), mesh)
    zpv = (zt_prior_var - comm.psum(torch.einsum("ij,ij->j", lam, Kit), mesh)
           - torch.einsum("ij,ij->j", mu, Pt.T))
    return _maybe_numpy(zpm, zpv, convert_out)


def _maybe_numpy(zpm, zpv, convert_out):
    if convert_out:
        return gnp.to_np(zpm), gnp.to_np(zpv)
    return zpm, zpv
