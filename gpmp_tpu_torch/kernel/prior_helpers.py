# gpmp_tpu_torch/kernel/prior_helpers.py
"""Resolution helpers for the prior-informed (REMAP) selection procedures.

Three concerns live here:

* deriving a safe componentwise lower bound ``logrho_min`` from the
  geometry of the observation points (smallest nonzero spacing vs. a
  fraction of the per-dimension range);
* deciding which covariance-parameter vector plays the *prior anchor*
  role and which plays the *optimizer start* role, for both fresh
  ``select_*`` calls and warm ``update_*`` calls;
* bundling the full hyperparameter set of the gaussian-logsigma2 +
  logrho-barrier prior.

Counterpart of gpmp_tpu/kernel/prior_helpers.py.  Host-side module: the
geometry scan runs once per fit on NumPy (one copy of the points to the
host), and the memoized initial guess at most once per fit.
"""

import warnings

import numpy as np

import gpmp_tpu_torch.num as gnp
from .init import anisotropic_parameters_initial_guess
from . import prior_defaults as _defaults


# ---------------------------------------------------------------------------
# logrho_min geometry
# ---------------------------------------------------------------------------

def _per_dim_gap_and_range(xi):
    """Vectorized per-dimension (smallest positive spacing, range).

    Dimensions with no positive spacing (all points coincide) get an
    ``inf`` gap.  Returns two NumPy arrays of shape ``(d,)``.
    """
    x = np.asarray(gnp.to_np(xi), dtype=float)
    spread = x.max(axis=0) - x.min(axis=0)
    if x.shape[0] < 2:
        return np.full(x.shape[1], np.inf), spread
    steps = np.diff(np.sort(x, axis=0), axis=0)
    steps = np.where(steps > 0.0, steps, np.inf)
    return steps.min(axis=0), spread


def _log_or_neginf(v):
    """Elementwise ``log`` where the entry is positive and finite, else ``-inf``."""
    v = np.asarray(v, dtype=float)
    usable = np.isfinite(v) & (v > 0.0)
    return np.where(usable, np.log(np.where(usable, v, 1.0)), -np.inf)


def _minimum_nonzero_gap_distance_1d(xj):
    """Smallest positive spacing among 1-D points (``inf`` if none)."""
    points = np.asarray(xj, dtype=float).reshape(-1, 1)
    gap, _ = _per_dim_gap_and_range(points)
    return float(gap[0])


def compute_logrho_min_from_xi(xi, prior_rho_min_range_factor=None):
    """Safeguarded componentwise lower bound for ``logrho``.

    Per dimension, the tighter (larger) of two floors is kept:
    ``log(min nonzero gap)`` and ``log(range * factor)``.  The factor
    defaults to the configured ``rho_min_range_factor``.
    """
    if prior_rho_min_range_factor is None:
        defaults = _defaults.get_default_prior_hyperparameters(xi)
        prior_rho_min_range_factor = defaults["rho_min_range_factor"]
    if prior_rho_min_range_factor <= 0:
        raise ValueError(
            f"rho_min_range_factor: got {prior_rho_min_range_factor}, "
            "need a value > 0"
        )
    gap, spread = _per_dim_gap_and_range(xi)
    floor_from_gap = _log_or_neginf(gap)
    floor_from_range = _log_or_neginf(spread * float(prior_rho_min_range_factor))
    return gnp.asarray(np.maximum(floor_from_gap, floor_from_range))


# ---------------------------------------------------------------------------
# covparam0 role resolution
# ---------------------------------------------------------------------------

def _first_set(*tagged):
    """First ``(tag, value)`` pair whose value is not None, else ``(None, None)``."""
    for tag, val in tagged:
        if val is not None:
            return tag, val
    return None, None


def _memoized_guess(model, xi, zi, dataloader):
    """Thunk computing the anisotropic initial guess at most once."""
    box = []

    def value():
        if not box:
            box.append(
                anisotropic_parameters_initial_guess(model, xi, zi, dataloader)
            )
        return box[0]

    return value


def resolve_covparam0_prior_and_init(
    model, xi=None, zi=None, dataloader=None, *,
    covparam0=None, covparam0_prior=None, covparam0_init=None,
):
    """Pick the prior anchor and the optimizer start for a fresh selection.

    Explicit ``covparam0_prior`` / ``covparam0_init`` win; otherwise the
    shared ``covparam0`` fills either role; otherwise one anisotropic
    initial guess covers both.
    """
    guess = _memoized_guess(model, xi, zi, dataloader)
    if covparam0_init is None:
        covparam0_init = covparam0 if covparam0 is not None else guess()
    if covparam0_prior is None:
        covparam0_prior = covparam0 if covparam0 is not None else guess()
    return covparam0_prior, covparam0_init


def _note_implicit_anchor(source, enabled):
    if enabled:
        warnings.warn(
            f"no covparam0_prior given to this update procedure; anchoring "
            f"the prior at {source}. Pass covparam0_prior explicitly to "
            f"decouple the prior anchor from the optimizer start.",
            stacklevel=3,
        )


def resolve_covparam0_roles_for_update(
    model, xi=None, zi=None, dataloader=None, *,
    covparam0=None, covparam0_prior=None, covparam0_init=None,
    warn_covparam0_prior=True,
):
    """Role resolution for warm ``update_*`` procedures.

    Fallback chain for both roles: explicit argument, shared
    ``covparam0``, current ``model.covparam``, fresh initial guess.
    Anchoring the prior implicitly (at ``covparam0`` or
    ``model.covparam``) emits a warning, since that couples the prior to
    the optimizer trajectory.
    """
    guess = _memoized_guess(model, xi, zi, dataloader)
    fallbacks = (("covparam0", covparam0), ("model.covparam", model.covparam))

    if covparam0_init is None:
        _, covparam0_init = _first_set(*fallbacks)
        if covparam0_init is None:
            covparam0_init = guess()

    if covparam0_prior is None:
        source, covparam0_prior = _first_set(*fallbacks)
        if covparam0_prior is None:
            covparam0_prior = guess()
        else:
            _note_implicit_anchor(source, warn_covparam0_prior)

    return covparam0_prior, covparam0_init


# ---------------------------------------------------------------------------
# full prior hyperparameter bundle
# ---------------------------------------------------------------------------

def resolve_logsigma2_logrho_prior_args(
    *, covparam0_prior, xi=None, dataloader=None,
    prior_gamma=None, prior_sigma2_coverage=None, prior_alpha=None,
    prior_rho_min_range_factor=None, prior_log_sigma2_0=None,
    prior_logrho_0=None, prior_logrho_min=None,
):
    """Resolve every hyperparameter of the gaussian-logsigma2 + logrho prior.

    Unset scalar hyperparameters come from the configured defaults; the
    prior centers come from ``covparam0_prior`` (``logrho_0 =
    -covparam0_prior[1:]`` under the ``loginvrho`` convention); and
    ``logrho_min`` is derived from the observation points when not given.
    """
    scalars = _defaults.resolve_prior_defaults_for_selection(
        xi=xi, dataloader=dataloader, gamma=prior_gamma,
        sigma2_coverage=prior_sigma2_coverage, alpha=prior_alpha,
        rho_min_range_factor=prior_rho_min_range_factor,
    )
    (prior_gamma, prior_sigma2_coverage, prior_alpha,
     prior_rho_min_range_factor) = scalars

    covparam0_prior = gnp._tensor(covparam0_prior)
    if prior_log_sigma2_0 is None:
        prior_log_sigma2_0 = covparam0_prior[0]
    prior_logrho_0 = gnp.asarray(
        -covparam0_prior[1:] if prior_logrho_0 is None else prior_logrho_0
    )

    if prior_logrho_min is None:
        points = xi
        if points is None and dataloader is not None:
            if not hasattr(getattr(dataloader, "dataset", None), "x_list"):
                raise ValueError(
                    "dataloader.dataset must provide x_list when "
                    "prior_logrho_min is None."
                )
            points = _defaults._xi_from_loader(dataloader)
        if points is None:
            raise ValueError(
                "xi or dataloader.dataset.x_list must be provided when "
                "prior_logrho_min is None."
            )
        prior_logrho_min = compute_logrho_min_from_xi(
            points, prior_rho_min_range_factor=prior_rho_min_range_factor
        )
    prior_logrho_min = gnp.asarray(prior_logrho_min)

    return (prior_gamma, prior_sigma2_coverage, prior_alpha,
            prior_rho_min_range_factor, prior_log_sigma2_0,
            prior_logrho_0, prior_logrho_min)
