# gpmp_tpu_torch/kernel/prior_defaults.py
"""Process-wide default hyperparameters for the covariance-parameter priors.

A small registry holds one entry per hyperparameter (default value,
validity predicate, error message).  The REMAP selection procedures read
these defaults whenever the caller does not pass explicit prior
hyperparameters.

Hyperparameters
---------------
gamma
    Multiplicative half-width of the calibrated log-variance Gaussian
    prior (``> 1``).
sigma2_coverage
    Central probability mass assigned to ``[sigma0^2/gamma,
    sigma0^2*gamma]`` by that prior (in ``(0, 1)``).
alpha
    Slope of the linear tail of the log-range barrier prior (``> 0``).
rho_min_range_factor
    Factor of the per-dimension data range used as a floor when deriving
    ``logrho_min`` (``> 0``).

Counterpart of gpmp_tpu/kernel/prior_defaults.py.  The registry is the
port's own: setting a default here leaves gpmp_tpu's unchanged, and the
reverse.
"""

# name -> (initial default, validity predicate, error message)
_REGISTRY = {
    "gamma": (1.5, lambda v: v > 1.0, "gamma must be > 1."),
    "sigma2_coverage": (
        0.95,
        lambda v: 0.0 < v < 1.0,
        "sigma2_coverage must be in (0, 1).",
    ),
    "alpha": (1.0, lambda v: v > 0.0, "alpha must be > 0."),
    "rho_min_range_factor": (
        0.05,
        lambda v: v > 0.0,
        "rho_min_range_factor must be > 0.",
    ),
}

# kwargs spelling used by the selection procedures -> registry name
_KWARG_ALIASES = {
    "prior_logsigma2_gamma": "gamma",
    "prior_logsigma2_coverage": "sigma2_coverage",
    "prior_logrho_alpha": "alpha",
    "prior_logrho_min_range_factor": "rho_min_range_factor",
}

_values = {name: spec[0] for name, spec in _REGISTRY.items()}


def _check_xi(xi):
    if xi is None or not hasattr(xi, "shape"):
        return
    if len(tuple(xi.shape)) != 2:
        raise ValueError("xi must have shape (n, d).")


def get_default_prior_hyperparameters(xi=None):
    """Return the current prior-default hyperparameters as a dict.

    ``xi`` is accepted (and shape-checked) for forward compatibility
    with dataset-conditioned default policies; current defaults do not
    depend on it.
    """
    _check_xi(xi)
    return dict(_values)


def set_default_prior_hyperparameters(**updates):
    """Update one or more default prior hyperparameters.

    Keyword-only; accepted names are ``gamma``, ``sigma2_coverage``,
    ``alpha`` and ``rho_min_range_factor``.  Each value is validated
    before the registry is touched.
    """
    for name, value in updates.items():
        if name not in _REGISTRY:
            raise TypeError(f"unknown prior hyperparameter: {name!r}")
        if value is None:
            continue
        value = float(value)
        _, valid, message = _REGISTRY[name]
        if not valid(value):
            raise ValueError(message)
        _values[name] = value


def set_default_prior_hyperparameters_from_kwargs(kwargs):
    """Pop recognized ``prior_*`` keys from ``kwargs`` and apply them.

    Recognized spellings are the ``prior_logsigma2_gamma`` /
    ``prior_logsigma2_coverage`` / ``prior_logrho_alpha`` /
    ``prior_logrho_min_range_factor`` aliases used by the selection
    procedures; ``kwargs`` is mutated in place.
    """
    for alias, name in _KWARG_ALIASES.items():
        if alias in kwargs:
            set_default_prior_hyperparameters(**{name: kwargs.pop(alias)})


def _xi_from_loader(dataloader):
    ds = getattr(dataloader, "dataset", None)
    shards = getattr(ds, "x_list", None)
    if shards is None:
        return None
    if isinstance(shards, list):
        import torch  # deferred: keep module import light

        return torch.cat(shards, dim=0)  # on the shards' device
    return shards


def resolve_prior_defaults_for_selection(
    xi=None,
    dataloader=None,
    gamma=None,
    sigma2_coverage=None,
    alpha=None,
    rho_min_range_factor=None,
):
    """Fill unset prior hyperparameters from the defaults.

    Observation points come from ``xi`` or, failing that, the
    dataloader's dataset shards.  Returns the tuple ``(gamma,
    sigma2_coverage, alpha, rho_min_range_factor)``.
    """
    points = xi if xi is not None else (
        _xi_from_loader(dataloader) if dataloader is not None else None
    )
    defaults = get_default_prior_hyperparameters(points)
    explicit = {
        "gamma": gamma,
        "sigma2_coverage": sigma2_coverage,
        "alpha": alpha,
        "rho_min_range_factor": rho_min_range_factor,
    }
    resolved = {
        name: defaults[name] if value is None else value
        for name, value in explicit.items()
    }
    return (
        resolved["gamma"],
        resolved["sigma2_coverage"],
        resolved["alpha"],
        resolved["rho_min_range_factor"],
    )
