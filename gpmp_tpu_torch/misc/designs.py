# gpmp_tpu_torch/misc/designs.py
# Copied verbatim from gpmp_tpu/misc/designs.py (host-side NumPy/SciPy).
"""Design-of-experiments utilities (host-side NumPy/SciPy).

API parity with the reference GPmp's misc/designs.py:16-305.  Deltas:
- every random design accepts an optional ``rng`` (numpy Generator) or
  ``seed`` for reproducibility (the reference uses the unseeded global
  np.random, designs.py:195-197, making examples non-reproducible);
- ``filldist_approx`` is vectorized (the reference recomputes the same
  distance matrix in a Python loop, designs.py:96-101).
"""

import numpy as np
from scipy.spatial.distance import cdist, pdist
from scipy.stats import qmc


def _resolve_rng(rng=None, seed=None):
    if rng is not None:
        return rng
    if seed is not None:
        return np.random.default_rng(seed)
    return None  # fall back to legacy np.random for reference parity


def maxdist(sample):
    """Diameter: maximum pairwise distance within the sample."""
    return float(np.max(pdist(sample)))


def mindist(sample):
    """Separation: minimum pairwise distance within the sample."""
    return float(np.min(pdist(sample)))


def discrepancy(sample):
    """Centered discrepancy of a sample in [0,1]^d (scipy.stats.qmc)."""
    return qmc.discrepancy(sample)


def filldist_approx(sample, box, n=int(1e6), x=None, rng=None, seed=None):
    """Approximate fill distance: max over a random discretization of the
    distance to the nearest sample point."""
    dim = sample.shape[1]
    if x is None:
        x = randunif(dim, n, box, rng=rng, seed=seed)
    D = cdist(x, sample)
    return float(np.max(np.min(D, axis=1)))


def scale(sample_standard, box):
    """Affinely map a sample in [0,1]^d onto the box [box[0], box[1]]."""
    l_bounds, u_bounds = box[0], box[1]
    return qmc.scale(sample_standard, l_bounds, u_bounds)


def regulargrid(dim, n, box):
    """Full-factorial regular grid; n is an int (n^dim points) or a list of
    per-dimension counts (prod(n) points)."""
    if not isinstance(n, list):
        n = [n] * dim
    xmin, xmax = box[0], box[1]
    levels = [np.linspace(xmin[i], xmax[i], n[i]) for i in range(dim)]
    mesh = np.meshgrid(*levels, indexing="ij")
    N = int(np.prod(n))
    x = np.zeros((N, dim))
    for i in range(dim):
        x[:, i] = mesh[i].reshape(N)
    return x


def randunif(dim, n, box, rng=None, seed=None):
    """Uniform random sample in the box."""
    r = _resolve_rng(rng, seed)
    u = r.random((n, dim)) if r is not None else np.random.rand(n, dim)
    return scale(u, box)


def ldrandunif(dim, n, box, max_iter=50, rng=None, seed=None):
    """Best-discrepancy-of-max_iter uniform random sample in the box."""
    r = _resolve_rng(rng, seed)
    best_d = np.inf
    best = None
    for _ in range(max_iter):
        u = r.random((n, dim)) if r is not None else np.random.rand(n, dim)
        d = discrepancy(u)
        if d < best_d:
            best_d, best = d, u
    return scale(best, box)


def maximinlhs(dim, n, box, max_iter=1000, rng=None, seed=None):
    """Maximin Latin hypercube: best separation among max_iter LHS draws."""
    r = _resolve_rng(rng, seed)
    sampler = qmc.LatinHypercube(d=dim, optimization=None, seed=r)
    best_sep = 0.0
    best = None
    for _ in range(max_iter):
        u = sampler.random(n)
        d = mindist(u)
        if d > best_sep:
            best_sep, best = d, u
    return scale(best, box)


def maximinldlhs(dim, n, box, max_iter=10, rng=None, seed=None):
    """Maximin low-discrepancy LHS via scipy 'random-cd' optimization."""
    r = _resolve_rng(rng, seed)
    sampler = qmc.LatinHypercube(d=dim, optimization="random-cd", seed=r)
    best_sep = 0.0
    best = None
    for _ in range(max_iter):
        u = sampler.random(n)
        d = mindist(u)
        if d > best_sep:
            best_sep, best = d, u
    return scale(best, box)
