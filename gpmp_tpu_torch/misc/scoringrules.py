# gpmp_tpu_torch/misc/scoringrules.py
"""Proper scoring rules for Gaussian predictive distributions.

Implements the continuous ranked probability score (CRPS), its
interval-truncated variant, and the first/second-order upper expected
improvements used by the truncated score, all in closed form on the
``gnp`` namespace (tensor ops; ``ei2_up``'s bivariate normal cdf is
SciPy's, on the host).  Counterpart of gpmp_tpu/misc/scoringrules.py.

Behavioral parity surface: gpmp/misc/scoringrules.py
(crps_gaussian, ei1_up, ei2_up, tcrps_gaussian, h1).

Math notes
----------
With phi/Phi the standard normal pdf/cdf and ``t = (z - mu)/sigma``:

  CRPS(N(mu, s^2), z) = s * [ 2 phi(t) + t (2 Phi(t) - 1) - 1/sqrt(pi) ]

  EI1_up(N(mu, s^2), z) = s * [ u Phi(u) + phi(u) ],  u = (mu - z)/s

  EI2_up uses the bivariate normal orthant term with covariance
  [[1, 1], [1, 2]]  (= D D^T for D = [[-1, 0], [-1, 1]]).

The truncated CRPS on [a, b] decomposes as
  base + spread - 2 * overshoot
where `base` is the realized interval overlap, `spread` is an EI2
difference across the interval, and `overshoot` is an EI1 excess term
active when the observation lies below the upper bound.
"""

import math

import gpmp_tpu_torch.num as gnp

_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
_SQRT_2 = math.sqrt(2.0)


def crps_gaussian(mu, sigma, z):
    """Closed-form CRPS of ``N(mu, sigma^2)`` against observation ``z``.

    All arguments broadcast elementwise; returns an array of CRPS
    values (lower is better; proper scoring rule).
    """
    mu, sigma, z = gnp.asarray(mu), gnp.asarray(sigma), gnp.asarray(z)
    t = (z - mu) / sigma
    pinball = t * (2 * gnp.normal.cdf(t) - 1)
    return sigma * (2 * gnp.normal.pdf(t) + pinball - _INV_SQRT_PI)


def h1(t):
    """Standard-normal first-order loss function ``t Phi(t) + phi(t)``."""
    t = gnp._tensor(t)
    return t * gnp.normal.cdf(t) + gnp.normal.pdf(t)


def ei1_up(mu, sigma, z):
    """First-order upper expected improvement of ``N(mu, sigma^2)`` over ``z``."""
    mu, sigma, z = gnp._tensor(mu), gnp._tensor(sigma), gnp._tensor(z)
    return sigma * h1((mu - z) / sigma)


# Covariance of the bivariate orthant term in EI2_up: D D^T for
# D = [[-1, 0], [-1, 1]].
_EI2_COV = ((1.0, 1.0), (1.0, 2.0))


def ei2_up(mu, sigma, z):
    """Second-order upper expected improvement of ``N(mu, sigma^2)`` over ``z``."""
    mu, sigma, z = gnp._tensor(mu), gnp._tensor(sigma), gnp._tensor(z)
    t = (mu - z) / sigma
    if gnp.isscalar(t):
        t = t.reshape(1)
    t_col = t.reshape(-1, 1)
    pts = gnp.hstack((t_col, gnp.zeros_like(t_col)))
    orthant = gnp.multivariate_normal.cdf(
        pts, mean=gnp.zeros(2), cov=gnp.array(_EI2_COV)
    )
    tail = gnp.normal.pdf(t) * gnp.normal.cdf(-t)
    half_var = _INV_SQRT_PI * gnp.normal.cdf(_SQRT_2 * t)
    return sigma * (2.0 * (t * orthant + tail) + half_var)


def tcrps_gaussian(mu, sigma, z, a=-gnp.inf, b=gnp.inf):
    """CRPS truncated to the interval ``[a, b]``.

    Reduces to :func:`crps_gaussian` when both bounds are infinite; a
    finite lower bound alone is handled by reflecting the problem onto
    the upper-bounded case.
    """
    mu, sigma, z = gnp.asarray(mu), gnp.asarray(sigma), gnp.asarray(z)
    a, b = gnp.asarray(a), gnp.asarray(b)
    has_lower = bool(gnp.isfinite(a))
    has_upper = bool(gnp.isfinite(b))

    if not has_upper:
        if not has_lower:
            return crps_gaussian(mu, sigma, z)
        # [a, inf) for N(mu, .) at z  ==  (-inf, -a] for N(-mu, .) at -z
        return tcrps_gaussian(-mu, sigma, -z, b=-a)

    # Upper bound present.  With a = -inf, maximum(a, z) is just z, so
    # the overshoot term is shared between the two cases.
    overshoot = gnp.where(
        z <= b,
        ei1_up(mu, sigma, b) - ei1_up(mu, sigma, gnp.maximum(a, z)),
        0.0,
    )
    if has_lower:
        base = gnp.maximum(gnp.minimum(b, z) - a, 0.0)
        spread = ei2_up(mu, sigma, b) - ei2_up(mu, sigma, a)
    else:
        base = gnp.minimum(b, z)
        spread = ei2_up(mu, sigma, b) - (mu + sigma * _INV_SQRT_PI)
    return base + spread - 2.0 * overshoot
