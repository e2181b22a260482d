# gpmp_tpu_torch/kernel/__init__.py
"""GP kernels and parameter selection (counterpart of gpmp_tpu/kernel;
REMAP, priors and bounds factories are not ported yet)."""

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
)

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
]
