# gpmp_tpu_torch/parallel/gram.py
"""Row-sharded gram construction and matvec (counterpart of
gpmp_tpu/parallel/gram.py).

On a group mesh (parallel/mesh.py) rank r computes its (n/R, n) row slab of
the covariance from the replicated points, and a matvec of a slab with a
replicated vector is this rank's rows of K v: no K-sized communication.  On
a one-card mesh the slab is the whole matrix.
"""

from . import comm


def sharded_gram(cov_fn, x, covparam, mesh, axis_name="shard"):
    """This rank's row slab of K = cov_fn(x, x, covparam) (the whole K on a
    one-card mesh).  cov_fn takes (x_rows, y_cols, covparam) and returns the
    cross covariance, without assuming that x_rows is y_cols.  x: (n, d),
    replicated, n divisible by the rank count."""
    return cov_fn(comm.slab(x, mesh), x.clone(), covparam)  # the clone defeats `y is x`


def sharded_matvec(K_slab, v, mesh, axis_name="shard"):
    """This rank's rows of K v, from its row slab of K and the replicated v
    (K v on a one-card mesh)."""
    return K_slab @ v
