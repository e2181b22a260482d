# gpmp_tpu_torch/kernel/init.py
"""Initialization heuristics for GP covariance parameters.

Counterpart of gpmp_tpu/kernel/init.py (array sources only):
rho_j = exp(gammaln(d/2 + 1)/d) / sqrt(pi) * range_j (volume-of-ball
heuristic), then GLS sigma^2 at unit variance.
"""

import math

import torch

import gpmp_tpu_torch.num as gnp
from .utils import prepare_data


def _covparam_from_sigma2_and_rho(sigma2, rho):
    return torch.cat((torch.log(sigma2).reshape(1), -torch.log(rho)))


def _rho_heuristic(xi_, d):
    delta = torch.amax(xi_, dim=0) - torch.amin(xi_, dim=0)
    return math.exp(math.lgamma(d / 2 + 1) / d) / math.sqrt(math.pi) * delta


def _unit_covparam(rho):
    return torch.cat((torch.zeros(1, dtype=rho.dtype, device=rho.device),
                      -torch.log(rho)))


def anisotropic_parameters_initial_guess_zero_mean(model, xi=None, zi=None,
                                                   dataloader=None):
    """Anisotropic initialization with zero mean."""
    xi_, zi_, n, d, _ = prepare_data(xi, zi, dataloader)
    rho = _rho_heuristic(xi_, d)
    covparam = _unit_covparam(rho)
    sigma2_GLS = model.norm_k_sqrd_with_zero_mean(xi_, zi_, covparam) / n
    return _covparam_from_sigma2_and_rho(sigma2_GLS, rho)


def anisotropic_parameters_initial_guess_constant_mean(model, xi=None, zi=None,
                                                       dataloader=None):
    """Anisotropic initialization with a parameterized constant mean.
    Returns (meanparam0, covparam0)."""
    xi_, zi_, n, d, _ = prepare_data(xi, zi, dataloader)
    rho = _rho_heuristic(xi_, d)
    covparam = _unit_covparam(rho)
    zTKinvz, Kinv1, Kinvz = model.k_inverses(xi_, zi_, covparam)
    mean_GLS = torch.sum(Kinvz) / torch.sum(Kinv1)
    sigma2_GLS = (1.0 / n) * zTKinvz
    return mean_GLS.reshape(1), _covparam_from_sigma2_and_rho(sigma2_GLS, rho)


def anisotropic_parameters_initial_guess(model, xi=None, zi=None, dataloader=None):
    """Anisotropic initialization for linear-predictor mean handling."""
    xi_, zi_, n, d, _ = prepare_data(xi, zi, dataloader)
    rho = _rho_heuristic(xi_, d)
    covparam = _unit_covparam(rho)
    sigma2_GLS = (1.0 / n) * model.norm_k_sqrd(xi_, zi_, covparam)
    return _covparam_from_sigma2_and_rho(sigma2_GLS, rho)
