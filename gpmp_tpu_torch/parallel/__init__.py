# gpmp_tpu_torch/parallel/__init__.py
"""The one-card part of gpmp_tpu.parallel: a one-card mesh, the large-n
likelihoods on the streamed engine, and the model view that routes the
selection procedures' ``mesh=`` through them.

Not ported yet (ROADMAP queue 1 item 11): the blocked and sharded Cholesky
with its solves (K9), the resident sharded mixed engine (K8), sharded
predict, LOO and sample paths, the data-parallel batched criteria, and
meshes of more than one card (torch.distributed/NCCL).
"""

from .mesh import default_mesh, make_mesh
from .likelihood import (
    sharded_covariance,
    sharded_negative_log_likelihood_zero_mean,
    sharded_negative_log_restricted_likelihood,
)
from .streamed import streamed_mp_solve_and_logdet
from .view import ShardedModelView, auto_shard_block

__all__ = [
    "make_mesh",
    "default_mesh",
    "sharded_covariance",
    "sharded_negative_log_restricted_likelihood",
    "sharded_negative_log_likelihood_zero_mean",
    "ShardedModelView",
    "auto_shard_block",
    "streamed_mp_solve_and_logdet",
]
