# gpmp_tpu_torch/parallel/view.py
"""ShardedModelView: a Model proxy whose O(n^2)-memory operations run on a
mesh (one card, or the ranks of a group mesh, with replicated inputs and
results).

Counterpart of gpmp_tpu/parallel/view.py.  The view delegates every
attribute, writes included (parameter selection through the view updates
the underlying model), and overrides the methods whose dense
implementations would hold the full (n, n) covariance and its autograd
residuals:

  negative_log_restricted_likelihood / negative_log_likelihood* ->
      gpmp_tpu_torch.parallel.likelihood (streamed engine past the resident
      engines' memory, else the resident branch)
  predict -> gpmp_tpu_torch.parallel.predict.sharded_predict
  loo     -> gpmp_tpu_torch.parallel.loo.sharded_loo

The high-level selection procedures accept ``mesh=`` (and ``shard_block=``,
this view's ``block``) and wrap the model in this view.
"""

import warnings

import torch

import gpmp_tpu_torch.num as gnp

from .likelihood import (
    sharded_negative_log_likelihood_zero_mean,
    sharded_negative_log_restricted_likelihood,
)
from .loo import sharded_loo
from .predict import sharded_predict


def auto_shard_block(n, mesh, axis_name="shard", cap=512):
    """Largest panel size <= cap that divides the per-rank row count n / R
    (the resident branch's panel; a one-card mesh holds all n rows), so no
    panel straddles two ranks."""
    n_loc = max(1, n // mesh.size)
    b = min(int(cap), n_loc)
    while b > 1 and n_loc % b != 0:
        b -= 1
    return max(1, b)


class ShardedModelView:
    """Proxy of a gpmp_tpu_torch Model with mesh likelihoods, predict and
    LOO.  ``block=None`` (default) picks the panel size per call via
    auto_shard_block."""

    _OWN = ("_model", "_mesh", "_axis_name", "_block")

    def __init__(self, model, mesh, axis_name="shard", block=None):
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_mesh", mesh)
        object.__setattr__(self, "_axis_name", axis_name)
        object.__setattr__(self, "_block", block)

    def _block_for(self, n):
        if self._block is not None:
            return self._block
        return auto_shard_block(n, self._mesh, self._axis_name)

    # -- transparent delegation (writes reach the underlying model) ----
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_model"), name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_model"), name, value)

    def __repr__(self):
        return (f"ShardedModelView({self._model!r}, mesh={tuple(self._mesh.shape.items())}, "
                f"block={self._block})")

    # -- mesh overrides --------------------------------------------------
    def negative_log_restricted_likelihood(self, covparam, xi, zi, impl="profiled"):
        if impl != "profiled":
            raise NotImplementedError(
                "the sharded REML is profiled-only (contrast space would need a "
                "distributed complete QR)")
        return sharded_negative_log_restricted_likelihood(
            self._model, covparam, xi, zi, self._mesh, axis_name=self._axis_name,
            block=self._block_for(xi.shape[0]))

    def negative_log_likelihood_zero_mean(self, covparam, xi, zi):
        return sharded_negative_log_likelihood_zero_mean(
            self._model, covparam, xi, zi, self._mesh, axis_name=self._axis_name,
            block=self._block_for(xi.shape[0]))

    def negative_log_likelihood(self, meanparam, covparam, xi, zi):
        zi_prior_mean = self._model.mean(xi, meanparam).reshape(-1)
        centered = gnp.asarray(zi).reshape(-1) - zi_prior_mean
        return self.negative_log_likelihood_zero_mean(covparam, xi, centered)

    def predict(self, xi, zi, xt, **kwargs):
        convert_out = kwargs.pop("convert_out", False)
        zero_neg_variances = kwargs.pop("zero_neg_variances", True)
        if kwargs.pop("return_lambdas", False):
            raise NotImplementedError(
                "return_lambdas is not supported by the sharded predict (use "
                "parallel.sharded_kriging_weights)")
        kwargs.pop("convert_in", None)  # inputs are converted anyway
        if kwargs:
            raise TypeError(f"unsupported predict kwargs: {sorted(kwargs)}")
        xi = gnp.asarray(xi)
        zpm, zpv = sharded_predict(
            self._model, xi, zi, xt, self._mesh, axis_name=self._axis_name,
            block=self._block_for(xi.shape[0]))
        # Model.predict's negative-variance warning and clip
        if bool(torch.any(zpv < 0)):
            warnings.warn("Negative variances detected. Consider using jitter.",
                          RuntimeWarning)
            if zero_neg_variances:
                zpv = torch.clamp(zpv, min=0.0)
        if convert_out:
            return gnp.to_np(zpm), gnp.to_np(zpv)
        return zpm, zpv

    def loo(self, xi, zi, **_kwargs):
        xi = gnp.asarray(xi)
        return sharded_loo(self._model, xi, zi, self._mesh, axis_name=self._axis_name,
                           block=self._block_for(xi.shape[0]))
