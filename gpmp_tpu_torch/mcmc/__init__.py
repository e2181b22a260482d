# gpmp_tpu_torch/mcmc/__init__.py
"""MCMC and particle samplers for GP covariance-parameter posteriors
(counterpart of gpmp_tpu.mcmc): multi-chain adaptive MH, iterative-tree
NUTS, SMC (tempering and subset simulation) and annealed SVGD, their
param_posterior entry points, checkpoints and the covariance estimators.
SMC and SVGD evaluate the criterion over their whole population at once
(mcmc.population: K1p/K2p on the gram).  Exports resolve lazily (the JAX
package's layout).
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
    "ParticlesSetConfig",
    "SMCConfig",
    "ParticlesSet",
    "SMC",
    "run_smc_sampling",
    "log_indicator_density",
    "run_subset_simulation",
    "sample_from_selection_criterion_mh",
    "sample_from_selection_criterion_nuts",
    "sample_from_selection_criterion_smc",
    "sample_from_selection_criterion_svgd",
    "get_log_target_values",
    "SVGDOptions",
    "rbf_kernel_matrix",
    "svgd_step",
    "svgd_sample",
    "plot_svgd_empirical_distributions",
    "estimate_cov_matrix",
    "estimate_cov_matrix_knn",
]

NOT_PORTED = ()  # every name of gpmp_tpu.mcmc is ported

_EXPORT_TO_MODULE = {
    "MHOptions": "mh",
    "MetropolisHastings": "mh",
    "sample_multivariate_normal_with_jitter": "mh",
    "nuts_sample": "nuts",
    "nuts_resume": "nuts",
    "nuts_transition": "nuts",
    "NUTSOptions": "nuts",
    "plot_nuts_diagnostics": "nuts",
    "ParticlesSetConfig": "smc",
    "SMCConfig": "smc",
    "ParticlesSet": "smc",
    "SMC": "smc",
    "run_smc_sampling": "smc",
    "log_indicator_density": "smc",
    "run_subset_simulation": "smc",
    "sample_from_selection_criterion_mh": "param_posterior",
    "sample_from_selection_criterion_nuts": "param_posterior",
    "sample_from_selection_criterion_smc": "param_posterior",
    "sample_from_selection_criterion_svgd": "param_posterior",
    "get_log_target_values": "param_posterior",
    "SVGDOptions": "svgd",
    "rbf_kernel_matrix": "svgd",
    "svgd_step": "svgd",
    "svgd_sample": "svgd",
    "plot_svgd_empirical_distributions": "svgd",
    "estimate_cov_matrix": "knn_cov",
    "estimate_cov_matrix_knn": "knn_cov",
}


def __getattr__(name: str):
    module_name = _EXPORT_TO_MODULE.get(name)
    if module_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{module_name}")
    obj = getattr(module, name)
    globals()[name] = obj
    return obj


def __dir__():
    return sorted(set(globals().keys()) | set(__all__))
