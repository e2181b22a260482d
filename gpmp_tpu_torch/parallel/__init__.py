# gpmp_tpu_torch/parallel/__init__.py
"""The one-card part of gpmp_tpu.parallel: a one-card mesh; the blocked
Cholesky with refined panels and its solves (K8/K9); the large-n
likelihoods on the resident branch (the blocked f64 Cholesky or the sharded
mixed engine) and on the streamed engine; sharded predict, kriging
weights, sample paths and LOO; and the model view that routes the
selection procedures' ``mesh=`` through them.

Not ported yet (ROADMAP queue 1 item 11): meshes of more than one card
(torch.distributed/NCCL: the row-sharded factor, sharded gram and matvec)
and the data-parallel batched criteria.
"""

from .mesh import default_mesh, make_mesh
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
    "sharded_cholesky",
    "sharded_cholesky_solve",
    "sharded_solve_and_logdet",
    "blocked_solve_lower",
    "blocked_solve_upper_t",
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
