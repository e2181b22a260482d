# gpmp_tpu_torch/kernel/init.py
"""Initialization heuristics for GP covariance parameters.

Counterpart of gpmp_tpu/kernel/init.py:
rho_j = exp(gammaln(d/2 + 1)/d) / sqrt(pi) * range_j (volume-of-ball
heuristic), then GLS sigma^2 at unit variance.  From a dataloader, the
range comes from the dataset's streaming min and max, and sigma^2 (and the
GLS mean) is the batch-size-weighted mean of the per-batch values
(``DataLoader.reduce_mean``, one pass over the loader).
"""

import math

import torch

from .utils import prepare_data


def _covparam_from_sigma2_and_rho(sigma2, rho):
    return torch.cat((torch.log(sigma2).reshape(1), -torch.log(rho)))


def _rho_heuristic(xi_, dataloader, d, source):
    if source == "arrays":
        delta = torch.amax(xi_, dim=0) - torch.amin(xi_, dim=0)
    else:
        dataset = dataloader.dataset
        delta = dataset._reduce_max("x") - dataset._reduce_min("x")
    return math.exp(math.lgamma(d / 2 + 1) / d) / math.sqrt(math.pi) * delta


def _unit_covparam(rho):
    return torch.cat((torch.zeros(1, dtype=rho.dtype, device=rho.device),
                      -torch.log(rho)))


def anisotropic_parameters_initial_guess_zero_mean(model, xi=None, zi=None,
                                                   dataloader=None):
    """Anisotropic initialization with zero mean."""
    xi_, zi_, _n, d, source = prepare_data(xi, zi, dataloader)
    rho = _rho_heuristic(xi_, dataloader, d, source)
    covparam = _unit_covparam(rho)

    def sigma2_fn(x, z):
        return model.norm_k_sqrd_with_zero_mean(x, z, covparam) / x.shape[0]

    sigma2_GLS = (
        sigma2_fn(xi_, zi_) if source == "arrays" else dataloader.reduce_mean(sigma2_fn)
    )
    return _covparam_from_sigma2_and_rho(sigma2_GLS, rho)


def anisotropic_parameters_initial_guess_constant_mean(model, xi=None, zi=None,
                                                       dataloader=None):
    """Anisotropic initialization with a parameterized constant mean.
    Returns (meanparam0, covparam0)."""
    xi_, zi_, n, d, source = prepare_data(xi, zi, dataloader)
    rho = _rho_heuristic(xi_, dataloader, d, source)
    covparam = _unit_covparam(rho)
    if source == "arrays":
        zTKinvz, Kinv1, Kinvz = model.k_inverses(xi_, zi_, covparam)
        mean_GLS = torch.sum(Kinvz) / torch.sum(Kinv1)
        sigma2_GLS = (1.0 / n) * zTKinvz
    else:
        def per_batch_gls(x, z):
            zTKinvz, Kinv1, Kinvz = model.k_inverses(x, z, covparam)
            return torch.stack(
                [torch.sum(Kinvz) / torch.sum(Kinv1), (zTKinvz / x.shape[0]).reshape(())]
            )
        mean_and_sigma2 = dataloader.reduce_mean(per_batch_gls)
        mean_GLS, sigma2_GLS = mean_and_sigma2[0], mean_and_sigma2[1]
    return mean_GLS.reshape(1), _covparam_from_sigma2_and_rho(sigma2_GLS, rho)


def anisotropic_parameters_initial_guess(model, xi=None, zi=None, dataloader=None):
    """Anisotropic initialization for linear-predictor mean handling."""
    xi_, zi_, n, d, source = prepare_data(xi, zi, dataloader)
    rho = _rho_heuristic(xi_, dataloader, d, source)
    covparam = _unit_covparam(rho)
    if source == "arrays":
        sigma2_GLS = (1.0 / n) * model.norm_k_sqrd(xi_, zi_, covparam)
    else:
        def per_batch_sigma2(x, z):
            return model.norm_k_sqrd(x, z, covparam) / x.shape[0]
        sigma2_GLS = dataloader.reduce_mean(per_batch_sigma2)
    return _covparam_from_sigma2_and_rho(sigma2_GLS, rho)
