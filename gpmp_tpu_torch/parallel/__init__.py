# gpmp_tpu_torch/parallel/__init__.py
"""gpmp_tpu.parallel on PyTorch: meshes (one card, or the ranks of a
torch.distributed process group); the data-parallel batched criterion
(``make_data_parallel_criterion`` over ``shard_batches``' stacked
batches); the blocked Cholesky with refined panels
and its solves (K8/K9; on a group mesh the row-sharded factor with K9s);
the row-sharded gram and matvec; the large-n likelihoods on the resident
branch (the blocked f64 Cholesky or the sharded mixed engine) and on the
streamed engine (one card only); sharded predict, kriging weights, sample
paths and LOO; and the model view that routes the selection procedures'
``mesh=`` through them.

On a group mesh the low-level functions (``sharded_cholesky``, the blocked
solves, ``sharded_gram``, ``sharded_matvec``, ``sharded_covariance``,
``sharded_cross_covariance``) take and return this rank's row slab; the
criteria, predict, kriging weights, sample paths, LOO and the view take
replicated inputs and return the same replicated results on every rank.
``shard_batches`` gives this rank's share of the batches, and
``make_data_parallel_criterion`` the replicated value and gradient.
"""

from .mesh import default_mesh, make_mesh
from .batched import make_data_parallel_criterion, shard_batches
from .chol import (
    blocked_solve_lower,
    blocked_solve_upper_t,
    sharded_cholesky,
    sharded_cholesky_solve,
    sharded_solve_and_logdet,
)
from .likelihood import (
    sharded_covariance,
    sharded_negative_log_likelihood_zero_mean,
    sharded_negative_log_restricted_likelihood,
)
from .gram import sharded_gram, sharded_matvec
from .mixed import sharded_mp_solve_and_logdet
from .predict import (
    sharded_cross_covariance,
    sharded_kriging_weights,
    sharded_predict,
    sharded_sample_paths,
)
from .loo import sharded_loo
from .streamed import streamed_mp_solve_and_logdet
from .view import ShardedModelView, auto_shard_block

__all__ = [
    "make_mesh",
    "default_mesh",
    "make_data_parallel_criterion",
    "shard_batches",
    "sharded_cholesky",
    "sharded_cholesky_solve",
    "sharded_solve_and_logdet",
    "blocked_solve_lower",
    "blocked_solve_upper_t",
    "sharded_gram",
    "sharded_matvec",
    "sharded_covariance",
    "sharded_negative_log_restricted_likelihood",
    "sharded_negative_log_likelihood_zero_mean",
    "sharded_mp_solve_and_logdet",
    "sharded_predict",
    "sharded_cross_covariance",
    "sharded_kriging_weights",
    "sharded_sample_paths",
    "sharded_loo",
    "ShardedModelView",
    "auto_shard_block",
    "streamed_mp_solve_and_logdet",
]
