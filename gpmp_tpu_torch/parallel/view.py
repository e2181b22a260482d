# gpmp_tpu_torch/parallel/view.py
"""ShardedModelView: a Model proxy whose likelihoods run on a one-card mesh.

Counterpart of gpmp_tpu/parallel/view.py.  The view delegates every
attribute, writes included (parameter selection through the view updates
the underlying model), and overrides the likelihood methods with
gpmp_tpu_torch.parallel.likelihood, whose streamed engine never holds the
(n, n) covariance in f64.  ``predict`` and ``loo`` raise
NotImplementedError: ``sharded_predict`` and ``sharded_loo`` need the
blocked Cholesky of the next slice (K8/K9).  So does ``block=``, the
resident branch's panel size, which the streamed engine has no use for.
"""

import gpmp_tpu_torch.num as gnp

from .likelihood import (
    _not_ported,
    sharded_negative_log_likelihood_zero_mean,
    sharded_negative_log_restricted_likelihood,
)


def auto_shard_block(n, mesh, axis_name="shard", cap=512):
    """Largest panel size <= cap that divides the per-device row count (the
    resident branch's panel; one card holds all n rows)."""
    n_loc = max(1, n // mesh.size)
    b = min(int(cap), n_loc)
    while b > 1 and n_loc % b != 0:
        b -= 1
    return max(1, b)


class ShardedModelView:
    """Proxy of a gpmp_tpu_torch Model with mesh likelihoods.

    ``block`` (the resident branch's panel size) must be None until that
    branch is ported.
    """

    _OWN = ("_model", "_mesh", "_axis_name")

    def __init__(self, model, mesh, axis_name="shard", block=None):
        if block is not None:
            _not_ported("ShardedModelView(block=) (the resident branch's panel size)")
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_mesh", mesh)
        object.__setattr__(self, "_axis_name", axis_name)

    # -- transparent delegation (writes reach the underlying model) ----
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_model"), name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_model"), name, value)

    def __repr__(self):
        return f"ShardedModelView({self._model!r}, mesh={tuple(self._mesh.shape.items())})"

    # -- mesh overrides --------------------------------------------------
    def negative_log_restricted_likelihood(self, covparam, xi, zi, impl="profiled"):
        if impl != "profiled":
            raise NotImplementedError(
                "the sharded REML is profiled-only (contrast space would need a "
                "distributed complete QR)")
        return sharded_negative_log_restricted_likelihood(
            self._model, covparam, xi, zi, self._mesh, axis_name=self._axis_name)

    def negative_log_likelihood_zero_mean(self, covparam, xi, zi):
        return sharded_negative_log_likelihood_zero_mean(
            self._model, covparam, xi, zi, self._mesh, axis_name=self._axis_name)

    def negative_log_likelihood(self, meanparam, covparam, xi, zi):
        zi_prior_mean = self._model.mean(xi, meanparam).reshape(-1)
        centered = gnp.asarray(zi).reshape(-1) - zi_prior_mean
        return self.negative_log_likelihood_zero_mean(covparam, xi, centered)

    def predict(self, xi, zi, xt, **kwargs):
        _not_ported("ShardedModelView.predict (sharded_predict)")

    def loo(self, xi, zi, **kwargs):
        _not_ported("ShardedModelView.loo (sharded_loo)")
