# gpmp_tpu_torch/mcmc/__init__.py
"""MCMC samplers for GP covariance-parameter posteriors (counterpart of
gpmp_tpu.mcmc): multi-chain adaptive MH and iterative-tree NUTS, their
param_posterior entry points, checkpoints and the covariance estimators.
Exports resolve lazily (the JAX package's layout).

SMC, subset simulation and SVGD (``ParticlesSetConfig``, ``SMCConfig``,
``ParticlesSet``, ``SMC``, ``run_smc_sampling``, ``log_indicator_density``,
``run_subset_simulation``, ``sample_from_selection_criterion_smc``,
``sample_from_selection_criterion_svgd``, ``SVGDOptions``,
``rbf_kernel_matrix``, ``svgd_step``, ``svgd_sample``,
``plot_svgd_empirical_distributions``) are not ported yet: they evaluate
the criterion over a whole population of parameter vectors at once, and
wait for a population form of the gram kernels (ROADMAP queue 1, 10b).
"""

import importlib

__all__ = [
    "MHOptions",
    "MetropolisHastings",
    "sample_multivariate_normal_with_jitter",
    "nuts_sample",
    "nuts_resume",
    "nuts_transition",
    "NUTSOptions",
    "plot_nuts_diagnostics",
    "sample_from_selection_criterion_mh",
    "sample_from_selection_criterion_nuts",
    "get_log_target_values",
    "estimate_cov_matrix",
    "estimate_cov_matrix_knn",
]

# the JAX package's names that wait for the population slice
NOT_PORTED = (
    "ParticlesSetConfig",
    "SMCConfig",
    "ParticlesSet",
    "SMC",
    "run_smc_sampling",
    "log_indicator_density",
    "run_subset_simulation",
    "sample_from_selection_criterion_smc",
    "sample_from_selection_criterion_svgd",
    "SVGDOptions",
    "rbf_kernel_matrix",
    "svgd_step",
    "svgd_sample",
    "plot_svgd_empirical_distributions",
)

_EXPORT_TO_MODULE = {
    "MHOptions": "mh",
    "MetropolisHastings": "mh",
    "sample_multivariate_normal_with_jitter": "mh",
    "nuts_sample": "nuts",
    "nuts_resume": "nuts",
    "nuts_transition": "nuts",
    "NUTSOptions": "nuts",
    "plot_nuts_diagnostics": "nuts",
    "sample_from_selection_criterion_mh": "param_posterior",
    "sample_from_selection_criterion_nuts": "param_posterior",
    "get_log_target_values": "param_posterior",
    "estimate_cov_matrix": "knn_cov",
    "estimate_cov_matrix_knn": "knn_cov",
}


def __getattr__(name: str):
    module_name = _EXPORT_TO_MODULE.get(name)
    if module_name is None:
        if name in NOT_PORTED:
            raise AttributeError(
                f"{name} is not ported yet: SMC, subset simulation and SVGD wait "
                "for a population form of the gram kernels (ROADMAP queue 1, 10b)"
            )
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{module_name}")
    obj = getattr(module, name)
    globals()[name] = obj
    return obj


def __dir__():
    return sorted(set(globals().keys()) | set(__all__))
