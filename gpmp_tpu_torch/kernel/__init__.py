# gpmp_tpu_torch/kernel/__init__.py
"""GP kernels and parameter selection (counterpart of gpmp_tpu/kernel):
the covariance functions, the initial guesses, the selection criteria and
procedures (ML, REML, REMAP), the priors, their defaults and the empirical
bounds."""

from .exponential import exponential_kernel
from .matern import (
    matern32_kernel,
    maternp_covariance,
    maternp_covariance_ii_or_tt,
    maternp_covariance_it,
    maternp_kernel,
)
from .init import (
    anisotropic_parameters_initial_guess,
    anisotropic_parameters_initial_guess_constant_mean,
    anisotropic_parameters_initial_guess_zero_mean,
)
from .parameter_selection import (
    negative_log_likelihood_zero_mean,
    negative_log_likelihood,
    negative_log_restricted_likelihood,
    make_selection_criterion_with_gradient,
    autoselect_parameters,
    select_parameters_with_criterion,
    update_parameters_with_criterion,
    select_parameters_with_ml_constant_mean,
    update_parameters_with_ml_constant_mean,
    select_parameters_with_reml,
    update_parameters_with_reml,
    select_parameters_with_remap_with_power_laws_prior,
    update_parameters_with_remap_with_power_laws_prior,
    select_parameters_with_remap,
    update_parameters_with_remap,
    select_parameters_with_remap_gaussian_logsigma2,
    update_parameters_with_remap_gaussian_logsigma2,
    select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior,
    update_parameters_with_remap_gaussian_logsigma2_and_logrho_prior,
)
from .prior_helpers import compute_logrho_min_from_xi
from .priors import (
    log_prior_jeffreys_variance,
    log_prior_power_law,
    log_prior_gaussian_logsigma2,
    neglog_f_logrho,
    log_prior_logrho_barrier_linear,
    log_prior_reference,
    neg_log_restricted_posterior_with_jeffreys_prior,
    neg_log_restricted_posterior_power_laws_prior,
    neg_log_restricted_posterior_logsigma2_prior,
    neg_log_restricted_posterior_with_logrho_prior,
    neg_log_restricted_posterior_logsigma2_and_logrho_prior,
)
from .bounds import empirical_bounds_factory
from . import bounds, prior_defaults, prior_helpers, priors  # noqa: F401

__all__ = [
    "exponential_kernel",
    "matern32_kernel",
    "maternp_kernel",
    "maternp_covariance",
    "maternp_covariance_ii_or_tt",
    "maternp_covariance_it",
    "anisotropic_parameters_initial_guess",
    "anisotropic_parameters_initial_guess_constant_mean",
    "anisotropic_parameters_initial_guess_zero_mean",
    "negative_log_likelihood_zero_mean",
    "negative_log_likelihood",
    "negative_log_restricted_likelihood",
    "make_selection_criterion_with_gradient",
    "autoselect_parameters",
    "select_parameters_with_criterion",
    "update_parameters_with_criterion",
    "select_parameters_with_ml_constant_mean",
    "update_parameters_with_ml_constant_mean",
    "select_parameters_with_reml",
    "update_parameters_with_reml",
    "select_parameters_with_remap_with_power_laws_prior",
    "update_parameters_with_remap_with_power_laws_prior",
    "select_parameters_with_remap",
    "update_parameters_with_remap",
    "select_parameters_with_remap_gaussian_logsigma2",
    "update_parameters_with_remap_gaussian_logsigma2",
    "select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior",
    "update_parameters_with_remap_gaussian_logsigma2_and_logrho_prior",
    "compute_logrho_min_from_xi",
    "log_prior_jeffreys_variance",
    "log_prior_power_law",
    "log_prior_gaussian_logsigma2",
    "neglog_f_logrho",
    "log_prior_logrho_barrier_linear",
    "log_prior_reference",
    "neg_log_restricted_posterior_with_jeffreys_prior",
    "neg_log_restricted_posterior_power_laws_prior",
    "neg_log_restricted_posterior_logsigma2_prior",
    "neg_log_restricted_posterior_with_logrho_prior",
    "neg_log_restricted_posterior_logsigma2_and_logrho_prior",
    "empirical_bounds_factory",
    "prior_defaults",
]
