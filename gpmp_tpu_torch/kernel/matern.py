# gpmp_tpu_torch/kernel/matern.py
"""Matern covariance family (half-integer regularity nu = p + 1/2).

Counterpart of gpmp_tpu/kernel/matern.py.  The full (non-pairwise) gram
matrices go through ``ops.gram.matern_gram``: the hand-written K1/K2 CUDA
kernels on CUDA tensors, the plain torch composition on CPU tensors.  The
pairwise cross branch composes ``gnp.scaled_distance_elementwise`` (K1d)
with ``maternp_kernel`` (K1m), as user covariances do.
"""

import math

import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.ops.gram import (  # noqa: F401  (public names)
    _maternp_poly_coeffs,
    matern_gram,
    maternp_kernel,
)


def matern32_kernel(h):
    """Matern 3/2 kernel: K(h) = (1 + 2*sqrt(3/2)*h) * exp(-2*sqrt(3/2)*h)."""
    c = 2.0 * math.sqrt(3.0 / 2.0)
    t = c * h
    return (1.0 + t) * torch.exp(-t)


def maternp_covariance_ii_or_tt(x, p, param, pairwise=False):
    """Covariance among observations (or among predictands) at x.

    covparam layout: param = [log(sigma2), log(1/rho_1), ..., log(1/rho_d)].
    Adds the fixed relative nugget 10 * sigma2 * eps on the diagonal.
    """
    if pairwise:
        return torch.exp(param[0]) * torch.ones(
            (x.shape[0],), dtype=x.dtype, device=x.device
        )
    return matern_gram(x, x, p, param, same=True)


def maternp_covariance_it(x, y, p, param, pairwise=False):
    """Cross-covariance between observations x and prediction points y."""
    if pairwise:
        D = gnp.scaled_distance_elementwise(param[1:], x, y)
        return torch.exp(param[0]) * maternp_kernel(p, D)
    return matern_gram(x, y, p, param, same=False)


def maternp_covariance(x, y, p, param, pairwise=False):
    """Matern covariance wrapper; y is x / y is None selects the ii/tt path
    with nugget."""
    if y is x or y is None:
        return maternp_covariance_ii_or_tt(x, p, param, pairwise)
    return maternp_covariance_it(x, y, p, param, pairwise)
