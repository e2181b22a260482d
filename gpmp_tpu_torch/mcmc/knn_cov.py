# gpmp_tpu_torch/mcmc/knn_cov.py
"""Covariance estimation helpers (classical and local k-NN averaging).

Copy of gpmp_tpu/mcmc/knn_cov.py (host-side NumPy): when hnswlib is
unavailable the k-NN variant runs an exact brute-force neighbor search
rather than degrading to the classical estimator (particle clouds here are
small, n ~ 1e3, so exact search is cheap).  Results come back as the
port's tensors, on the configured device.
"""

import numpy as np

import gpmp_tpu_torch.num as gnp

try:
    import hnswlib

    HNSWLIB_AVAILABLE = True
except ImportError:
    HNSWLIB_AVAILABLE = False


def _host(x):
    return np.asarray(gnp.to_np(x), dtype=float)


def estimate_cov_matrix(x):
    """Classical sample covariance of x with shape (N, d) -> (d, d)."""
    x = _host(x)
    return gnp.asarray(np.atleast_2d(np.cov(x.T, ddof=1)))


def estimate_cov_matrix_knn(x, n_random=50, n_neighbors=50, ef=100,
                            max_ef_construction=200, M=16, rng=None):
    """Average of local k-NN sample covariances around random seeds.

    Uses an HNSW index when hnswlib is available; exact brute-force
    neighbor search otherwise.  ``rng`` is a numpy Generator.
    """
    x = _host(x)
    N, d = x.shape
    n_random = min(n_random, N)
    n_neighbors = min(n_neighbors, N)
    if rng is None:
        rng = np.random.default_rng()

    seed_idx = rng.choice(N, size=n_random, replace=False)

    if HNSWLIB_AVAILABLE:
        index = hnswlib.Index(space="l2", dim=d)
        index.init_index(max_elements=N, ef_construction=max_ef_construction, M=M)
        index.add_items(x)
        index.set_ef(ef)
        labels, _dist = index.knn_query(x[seed_idx], k=n_neighbors)
    else:
        # exact: squared distances from seeds to all points
        d2 = ((x[seed_idx, None, :] - x[None, :, :]) ** 2).sum(axis=2)
        labels = np.argpartition(d2, n_neighbors - 1, axis=1)[:, :n_neighbors]

    local_covs = np.stack(
        [np.atleast_2d(np.cov(x[lbl].T, ddof=1)) for lbl in labels]
    )
    return gnp.asarray(local_covs.mean(axis=0))
