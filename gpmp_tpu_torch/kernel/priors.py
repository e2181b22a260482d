# gpmp_tpu_torch/kernel/priors.py
"""Log-priors and MAP (REMAP) objectives for covariance parameters.

Counterpart of gpmp_tpu/kernel/priors.py.  Every prior here is a
differentiable function of ``covparam = [log sigma2, loginvrho_1..d]``
(a tensor); scalar hyperparameters are plain Python floats resolved on the
host.

Prior families
--------------
* Jeffreys-style variance prior ``-lambda * log sigma2``.
* Power-law prior with soft linear cutoffs on every component.
* Jeffreys-rule/reference prior ``0.5 log det I(theta)`` (Fisher-based;
  differentiable: its gradient is a third derivative of the covariance,
  core/fisher.py).
* Calibrated Gaussian prior on ``log sigma2``: its log-space std is chosen
  so a central mass ``sigma2_coverage`` falls inside
  ``[sigma2_0/gamma, sigma2_0*gamma]``.
* Barrier + linear-tail prior on ``logrho = -covparam[1:]`` with hard
  support ``logrho > logrho_min`` and penalty minimum at ``logrho_0``.

Each ``neg_log_restricted_posterior_*`` wrapper adds the REML criterion to
the matching prior terms; these are the REMAP selection objectives.
"""

import math
from statistics import NormalDist

import numpy as np
import torch

import gpmp_tpu_torch.num as gnp
from .prior_defaults import get_default_prior_hyperparameters


def _fill_from_defaults(xi=None, **given):
    """Replace None entries of ``given`` with the configured defaults."""
    defaults = get_default_prior_hyperparameters(xi)
    return tuple(
        defaults[name] if value is None else value
        for name, value in given.items()
    )


def _soft_hinge(x, threshold, slope):
    """Linear penalty ``slope * max(x - threshold, 0)`` (zero inside)."""
    return slope * gnp.maximum(x - threshold, 0)


# --------------------------------------------------------------------------
# basic priors
# --------------------------------------------------------------------------

def log_prior_jeffreys_variance(covparam, lambda_var=1.0):
    """Jeffreys-style variance prior: ``log p = -lambda_var * log sigma2``."""
    return -lambda_var * covparam[0]


def log_prior_power_law(
    covparam,
    lambda_var=1.0,
    cut_logvariance_high=9.21,
    lambda_lengthscales=0.0,
    cut_loginvrho_low=-9.21,
    cut_loginvrho_high=9.21,
    penalty_factor=100,
):
    """Power-law prior with soft linear cutoffs.

    Power-law exponents apply to ``log sigma2`` and to each
    ``loginvrho`` component; outside the cutoff box a linear penalty of
    slope ``penalty_factor`` takes over.  The variance cutoff term enters
    with a ``+`` sign, as in the JAX package.
    """
    log_sigma2, loginvrho = covparam[0], covparam[1:]
    variance_part = (
        -lambda_var * log_sigma2
        + _soft_hinge(log_sigma2, cut_logvariance_high, penalty_factor)
    )
    lengthscale_part = -(
        lambda_lengthscales * gnp.sum(loginvrho)
        + gnp.sum(_soft_hinge(-loginvrho, -cut_loginvrho_low, penalty_factor))
        + gnp.sum(_soft_hinge(loginvrho, cut_loginvrho_high, penalty_factor))
    )
    return variance_part + lengthscale_part


def log_prior_reference(model, covparam, xi):
    """Jeffreys-rule prior ``0.5 log det I(theta)`` from Fisher information
    (differentiable in ``covparam``)."""
    return 0.5 * gnp.logdet(model.fisher_information(xi, covparam))


# --------------------------------------------------------------------------
# calibrated Gaussian prior on log sigma2
# --------------------------------------------------------------------------

def _calibrated_logsigma2_std(gamma, sigma2_coverage):
    """Log-space std giving central mass ``sigma2_coverage`` to
    ``[sigma2_0/gamma, sigma2_0*gamma]``."""
    if gamma <= 1.0:
        raise ValueError("gamma must be > 1.")
    if not (0.0 < sigma2_coverage < 1.0):
        raise ValueError("sigma2_coverage must be in (0, 1).")
    upper_quantile = NormalDist().inv_cdf(0.5 * (1.0 + sigma2_coverage))
    if upper_quantile <= 0.0:
        raise ValueError("Invalid sigma2_coverage: non-positive Gaussian quantile.")
    return math.log(gamma) / upper_quantile


def log_prior_gaussian_logsigma2(
    covparam, log_sigma2_0, gamma=None, sigma2_coverage=None
):
    """Gaussian prior on ``log sigma2`` centered at ``log_sigma2_0``
    (up to its additive normalization constant)."""
    gamma, sigma2_coverage = _fill_from_defaults(
        gamma=gamma, sigma2_coverage=sigma2_coverage
    )
    std = _calibrated_logsigma2_std(gamma, sigma2_coverage)
    resid = (covparam[0] - log_sigma2_0) / std
    return -0.5 * resid * resid


# --------------------------------------------------------------------------
# barrier + linear-tail prior on logrho
# --------------------------------------------------------------------------

def _check_logrho_support(logrho_min, logrho_0):
    """Raise unless ``logrho_0 > logrho_min`` componentwise (host values)."""
    if bool(np.any(np.asarray(gnp.to_np(logrho_0)) <= np.asarray(gnp.to_np(logrho_min)))):
        raise ValueError("logrho_0 must be > logrho_min (componentwise).")


def neglog_f_logrho(logrho, logrho_min, logrho_0, alpha=None):
    """Elementwise barrier + linear-tail penalty on ``logrho``.

    With ``u = logrho - logrho_min`` and barrier weight ``w = alpha *
    (logrho_0 - logrho_min)`` (chosen so the minimum sits at
    ``logrho_0``), the penalty is ``alpha * u - w * log(u)`` for ``u >
    0`` and ``+inf`` otherwise; the gradient stays finite (zero outside).

    The support check ``logrho_0 > logrho_min`` runs here on host values
    (NumPy, Python, CPU tensors).  Tensors on the card are not read back,
    which would cost one synchronisation per criterion evaluation, and
    nothing is read under a torch.func transform (vmap, grad), whose
    tensors have no storage to read, as the JAX package skips it for
    tracers: the REMAP procedures check their bound values once, before the
    fit.
    """
    (alpha,) = _fill_from_defaults(alpha=alpha)
    if alpha <= 0:
        raise ValueError("alpha must be > 0.")
    if not (torch._C._are_functorch_transforms_active()
            or any(isinstance(v, torch.Tensor) and v.device.type != "cpu"
                   for v in (logrho_min, logrho_0))):
        _check_logrho_support(logrho_min, logrho_0)
    logrho = gnp._tensor(logrho)
    logrho_min = gnp._tensor(logrho_min).to(device=logrho.device, dtype=logrho.dtype)
    logrho_0 = gnp._tensor(logrho_0).to(device=logrho.device, dtype=logrho.dtype)

    barrier_weight = alpha * (logrho_0 - logrho_min)
    u = logrho - logrho_min
    inside = u > 0.0
    u_safe = torch.where(inside, u, 1.0)
    penalty = alpha * u_safe - barrier_weight * torch.log(u_safe)
    return torch.where(inside, penalty, math.inf)


def log_prior_logrho_barrier_linear(covparam, logrho_min, logrho_0, alpha=None):
    """Lengthscale prior induced through ``logrho = -covparam[1:]``."""
    (alpha,) = _fill_from_defaults(alpha=alpha)
    return -gnp.sum(
        neglog_f_logrho(-covparam[1:], logrho_min, logrho_0, alpha=alpha)
    )


# --------------------------------------------------------------------------
# REMAP objectives: REML criterion minus log-priors
# --------------------------------------------------------------------------

def neg_log_restricted_posterior_with_jeffreys_prior(
    model, covparam, xi, zi, lambda_var=1.0
):
    """REML criterion with the Jeffreys-style variance prior."""
    reml = model.negative_log_restricted_likelihood(covparam, xi, zi)
    return reml - log_prior_jeffreys_variance(covparam, lambda_var)


def neg_log_restricted_posterior_power_laws_prior(model, covparam, xi, zi):
    """REML criterion with the power-law + soft-cutoff prior."""
    reml = model.negative_log_restricted_likelihood(covparam, xi, zi)
    return reml - log_prior_power_law(covparam)


def neg_log_restricted_posterior_logsigma2_prior(
    model, covparam, xi, zi, log_sigma2_0, gamma=None, sigma2_coverage=None
):
    """REML criterion with the calibrated Gaussian log-variance prior."""
    reml = model.negative_log_restricted_likelihood(covparam, xi, zi)
    return reml - log_prior_gaussian_logsigma2(
        covparam, log_sigma2_0, gamma=gamma, sigma2_coverage=sigma2_coverage
    )


def neg_log_restricted_posterior_with_logrho_prior(
    model, covparam, xi, zi, logrho_min, logrho_0, alpha=None
):
    """REML criterion with the barrier/linear-tail lengthscale prior."""
    reml = model.negative_log_restricted_likelihood(covparam, xi, zi)
    return reml - log_prior_logrho_barrier_linear(
        covparam, logrho_min=logrho_min, logrho_0=logrho_0, alpha=alpha
    )


def neg_log_restricted_posterior_logsigma2_and_logrho_prior(
    model,
    covparam,
    xi,
    zi,
    log_sigma2_0,
    gamma=None,
    sigma2_coverage=None,
    logrho_min=None,
    logrho_0=None,
    alpha=None,
):
    """The default REMAP objective: REML + Gaussian log-variance prior
    + barrier/linear lengthscale prior."""
    if logrho_min is None or logrho_0 is None:
        raise ValueError("logrho_min and logrho_0 must be provided.")
    gamma, sigma2_coverage, alpha = _fill_from_defaults(
        xi=xi, gamma=gamma, sigma2_coverage=sigma2_coverage, alpha=alpha
    )
    reml = model.negative_log_restricted_likelihood(covparam, xi, zi)
    return (
        reml
        - log_prior_gaussian_logsigma2(
            covparam, log_sigma2_0, gamma=gamma, sigma2_coverage=sigma2_coverage
        )
        - log_prior_logrho_barrier_linear(
            covparam, logrho_min=logrho_min, logrho_0=logrho_0, alpha=alpha
        )
    )
