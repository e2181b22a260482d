# gpmp_tpu_torch/core/model.py
"""Gaussian Process model facade.

Counterpart of gpmp_tpu/core/model.py.  PyTorch runs eagerly, so there is
no per-instance jit cache; each method calls the pure routines of
``kriging``, ``likelihood``, ``linalg``, ``loo`` and ``sample_paths``
directly.  Its methods take NumPy arrays and Python sequences for
covparam, meanparam, xi, zi and xt, as the JAX package's do through
``jnp`` (``gnp._tensor``).
"""

import warnings

import torch

import gpmp_tpu_torch.num as gnp

from . import fisher, kriging, likelihood, linalg, loo, utils
from . import sample_paths as sample_paths_mod


class _BoundParams:
    """View binding the parameters, converted to tensors on the configured
    device, to the model callables: the model's own attributes may hold
    numpy arrays or lists."""

    __slots__ = ("mean", "covariance", "meanparam", "covparam", "meantype")

    def __init__(self, model, covparam, meanparam):
        self.mean = model.mean
        self.covariance = model.covariance
        self.meantype = model.meantype
        self.covparam = covparam
        self.meanparam = meanparam


class Model:
    """Gaussian Process model.

    Parameters
    ----------
    mean : callable or None
        P = mean(x, meanparam), (n, q); None when meantype == 'zero'.
    covariance : callable
        K = covariance(x, y, covparam, pairwise); y may be None (y := x).
    meanparam, covparam : array_like, optional
        1-D parameter vectors.
    meantype : {'zero', 'parameterized', 'linear_predictor'}
    """

    def __init__(self, mean, covariance, meanparam=None, covparam=None,
                 meantype="linear_predictor"):
        utils.validate_model_mean(meantype, mean, meanparam)
        self.meantype = meantype
        self.mean = mean
        self.meanparam = meanparam
        self.covparam = covparam
        self.covariance = covariance

    def __repr__(self):
        return "<gpmp_tpu_torch.core.Model object> " + hex(id(self))

    def __str__(self):
        if self.meantype == "zero":
            mean_desc = "Zero Mean"
        else:
            mean_desc = getattr(self.mean, "__name__", str(self.mean))
        cov_desc = getattr(self.covariance, "__name__", str(self.covariance))
        return (
            f"GP Model:\n"
            f"  Mean Type: {self.meantype}\n"
            f"  Mean Function: {mean_desc}\n"
            f"  Mean Parameters: {self.meanparam}\n"
            f"  Covariance Function: {cov_desc}\n"
            f"  Covariance Parameters: {self.covparam}"
        )

    def _bound(self):
        covparam = None if self.covparam is None else gnp.asarray(self.covparam)
        meanparam = None if self.meanparam is None else gnp.asarray(self.meanparam)
        return _BoundParams(self, covparam, meanparam)

    # ------------------------------------------------------------------
    # Kriging predictors
    # ------------------------------------------------------------------
    def kriging_predictor_with_zero_mean(self, xi, xt, return_type=0):
        return kriging.kriging_predictor_with_zero_mean(
            self._bound(), gnp._tensor(xi), gnp._tensor(xt), return_type
        )

    def kriging_predictor(self, xi, xt, return_type=0):
        return kriging.kriging_predictor(self._bound(), gnp._tensor(xi), gnp._tensor(xt),
                                         return_type)

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------
    def predict(self, xi, zi, xt, return_lambdas=False, zero_neg_variances=True,
                convert_in=True, convert_out=True):
        """Posterior mean/variance at xt given (xi, zi).

        Negative variances are warned about and, by default, clipped to 0.
        """
        xi, zi, xt = utils.ensure_shapes_and_type(
            xi=xi, zi=zi, xt=xt, convert=convert_in
        )
        zi_centered, zt_prior_mean, lambda_t, zpv = kriging.select_predictor(
            self._bound(), xi, zi, xt
        )
        zpm = zi_centered @ lambda_t + zt_prior_mean

        if bool(torch.any(zpv < 0.0)):
            warnings.warn(
                "Negative variances detected. Consider using jitter.",
                RuntimeWarning,
            )
        if zero_neg_variances:
            zpv = torch.clamp_min(zpv, 0.0)

        if convert_out:
            zpm = gnp.to_np(zpm)
            zpv = gnp.to_np(zpv)
        if return_lambdas:
            return zpm, zpv, lambda_t
        return zpm, zpv

    def loo(self, xi, zi, convert_in=True, convert_out=False):
        """Leave-one-out predictions via virtual cross-validation:
        (zloo, sigma2loo, eloo)."""
        xi_, zi_, _ = utils.ensure_shapes_and_type(xi=xi, zi=zi, convert=convert_in)
        zloo, sigma2loo, eloo = loo.loo(self._bound(), xi_, zi_)
        if convert_out:
            zloo, sigma2loo, eloo = map(gnp.to_np, (zloo, sigma2loo, eloo))
        return zloo, sigma2loo, eloo

    # ------------------------------------------------------------------
    # Likelihoods and norms
    # ------------------------------------------------------------------
    def negative_log_likelihood_zero_mean(self, covparam, xi, zi):
        return likelihood.negative_log_likelihood_zero_mean(self, covparam, xi, zi)

    def negative_log_likelihood(self, meanparam, covparam, xi, zi):
        return likelihood.negative_log_likelihood(self, meanparam, covparam, xi, zi)

    def negative_log_restricted_likelihood(self, covparam, xi, zi, impl="profiled"):
        return likelihood.negative_log_restricted_likelihood(
            self, covparam, xi, zi, impl=impl
        )

    def norm_k_sqrd_with_zero_mean(self, xi, zi, covparam):
        return linalg.norm_k_sqrd_with_zero_mean(self, *map(gnp._tensor, (xi, zi, covparam)))

    def k_inverses(self, xi, zi, covparam):
        return linalg.k_inverses(self, *map(gnp._tensor, (xi, zi, covparam)))

    def norm_k_sqrd(self, xi, zi, covparam):
        return linalg.norm_k_sqrd(self, *map(gnp._tensor, (xi, zi, covparam)))

    # ------------------------------------------------------------------
    # Fisher information
    # ------------------------------------------------------------------
    def fisher_information(self, xi, covparam=None, epsilon=1e-3):
        return fisher.fisher_information(self._bound(), xi, covparam=covparam,
                                         epsilon=epsilon)

    def fisher_information_cpd(self, xi, covparam=None, epsilon=1e-3):
        return fisher.fisher_information_cpd(self._bound(), xi, covparam=covparam,
                                             epsilon=epsilon)

    def fisher_information_torch(self, xi, covparam):
        return fisher.fisher_information_torch(self._bound(), xi, covparam)

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def sample_paths(self, xt, nb_paths, method="chol", check_result=True, generator=None):
        return sample_paths_mod.sample_paths(
            self._bound(), xt, nb_paths, method=method, check_result=check_result,
            generator=generator,
        )

    def conditional_sample_paths(self, ztsim, xi_ind, zi, xt_ind, lambda_t,
                                 convert_out=True):
        return sample_paths_mod.conditional_sample_paths(
            self._bound(), ztsim, xi_ind, zi, xt_ind, lambda_t, convert_out=convert_out
        )

    def conditional_sample_paths_parameterized_mean(
        self, ztsim, xi, xi_ind, zi, xt, xt_ind, lambda_t, convert_out=True
    ):
        return sample_paths_mod.conditional_sample_paths_parameterized_mean(
            self._bound(), ztsim, xi, xi_ind, zi, xt, xt_ind, lambda_t,
            convert_out=convert_out,
        )

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------
    @staticmethod
    def _ensure_shapes_and_type(*, xi=None, zi=None, xt=None, convert=True):
        return utils.ensure_shapes_and_type(xi=xi, zi=zi, xt=xt, convert=convert)

    @staticmethod
    def _validate_model_mean(meantype, mean, meanparam):
        return utils.validate_model_mean(meantype, mean, meanparam)
