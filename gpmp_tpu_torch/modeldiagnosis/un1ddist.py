# gpmp_tpu_torch/modeldiagnosis/un1ddist.py
"""One-dimensional distribution built from an unnormalized scalar log-pdf.

Used by the quadrature-based selection-criterion statistics: the
criterion profile ``J(theta_k)`` along one parameter becomes a pseudo
log-density ``-J``, and moments/quantiles are computed by adaptive
quadrature (``scipy.integrate.quad``) and bracketing root finds
(``scipy.optimize.brentq``).  Host-side by nature — the integrand is a
scalar Python callable.

Behavioral parity surface: gpmp/modeldiagnosis/un1ddist.py
(Unnormalized1DDistribution: f/pdf/cdf/mean/var/quantile, finite-bounds
quantile requirement).
"""

import math
from typing import Callable, Optional, Sequence

import numpy as np
import scipy.integrate
import scipy.optimize

# exp() saturation thresholds for float64
_EXP_OVERFLOW = 709.0
_EXP_UNDERFLOW = -745.0


class Unnormalized1DDistribution:
    """Distribution on ``(a, b)`` defined by an unnormalized log-pdf.

    The normalization constant ``Z`` is computed eagerly at
    construction; a non-finite or non-positive ``Z`` is an error.
    Bounds may be infinite except for :meth:`quantile`, which needs a
    finite bracket.
    """

    def __init__(self, log_pdf: Callable[[float], float], bounds, *,
                 quad_opts: Optional[dict] = None):
        lo, hi = bounds
        if not (isinstance(lo, (int, float)) and isinstance(hi, (int, float))):
            raise TypeError("bounds: expected a numeric pair (lower, upper).")
        if not lo < hi:
            raise ValueError("bounds: lower must be strictly below upper.")
        self.log_pdf = log_pdf
        self.bounds = (float(lo), float(hi))
        self._quad_opts = dict(quad_opts or {})
        self.Z = self._weighted_integral(lambda t: 1.0)
        if not (math.isfinite(self.Z) and self.Z > 0.0):
            raise ValueError(
                "normalization constant is not a positive finite number"
            )

    # -- density evaluation ------------------------------------------------

    def _density_at(self, x: float) -> float:
        """Unnormalized density at a scalar point, saturating exp()."""
        u = float(self.log_pdf(float(x)))
        if u > _EXP_OVERFLOW:
            return math.inf
        if u < _EXP_UNDERFLOW:
            return 0.0
        return math.exp(u)

    def f(self, x: Sequence[float]) -> np.ndarray:
        """Unnormalized density on a grid of points."""
        return np.fromiter(
            (self._density_at(t) for t in x), dtype=float, count=len(x)
        )

    def pdf(self, x: Sequence[float]) -> np.ndarray:
        """Normalized density on a grid of points."""
        return self.f(x) / self.Z

    # -- integrals ---------------------------------------------------------

    def _weighted_integral(self, weight, upper: Optional[float] = None) -> float:
        """Adaptive quadrature of ``weight(t) * density(t)`` over the support
        (or up to ``upper``)."""
        lo, hi = self.bounds
        value, _err = scipy.integrate.quad(
            lambda t: weight(t) * self._density_at(t),
            lo,
            hi if upper is None else upper,
            **self._quad_opts,
        )
        return float(value)

    def cdf(self, x: float) -> float:
        """Cumulative probability at a scalar point."""
        lo, hi = self.bounds
        x = float(x)
        if x <= lo:
            return 0.0
        if x >= hi:
            return 1.0
        return self._weighted_integral(lambda t: 1.0, upper=x) / self.Z

    def mean(self) -> float:
        """First moment."""
        return self._weighted_integral(lambda t: t) / self.Z

    def var(self) -> float:
        """Variance, from the raw second moment."""
        mu = self.mean()
        second = self._weighted_integral(lambda t: t * t) / self.Z
        return second - mu * mu

    def quantile(self, p: float, *, xtol: float = 1e-6) -> float:
        """Level-``p`` quantile by bracketing root find (finite bounds only)."""
        p = float(p)
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile level {p} outside the open interval (0, 1)")
        lo, hi = self.bounds
        if math.isinf(lo) or math.isinf(hi):
            raise ValueError("quantile needs a finite bracket; got infinite bounds")
        return float(
            scipy.optimize.brentq(lambda t: self.cdf(t) - p, lo, hi, xtol=xtol)
        )


__all__ = ["Unnormalized1DDistribution"]
