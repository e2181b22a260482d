# tests/test_torch_slice.py
"""The whole slice -- REML selection then predict -- through both packages.

(a) the README quick start (1-D twobumps, ni=6, Matern p=3);
(b) example04's shape (Hartmann6, d=6, p=2) at ni=100, nt=200.

Held to: converged covparam abs 1e-3, each package's REML value at its
own optimum rel 1e-6, predictions of both at one shared covparam rel 1e-8
(max |diff| / max |value|).  Also: a covariance that cannot be factorized
gives +inf with a zero gradient, not an exception.

(c) bench.py's noisy-regression model (Matern p=2 plus a noise variance,
d=6, seed 7) at n=256, above the mixed engine's gate, on the mixed engine
of both packages: REML value rel 1e-10 and gradient rel 1e-6 per component
against gpmp_tpu's mixed engine (and within the class envelope of
BENCHMARKS.md, 1e-3 for log s2 and 1e-4 for the others, against the port's
own f64 engine); 15 SLSQP iterations from bench.py's p0 reach the same
covparam to 1e-3 and criterion to rel 1e-6; LOO and predictions at one
shared covparam rel 1e-8.
"""

import contextlib

import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.num as jgnp
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.misc  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu.config import set_chol_engine as jax_set_chol_engine
from gpmp_tpu_torch.interop import params_from_numpy
from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import mixed


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _models(p):
    def jmean(x, param):
        return jgnp.ones((x.shape[0], 1))

    def jkernel(x, y, c, pairwise=False):
        return jgp.kernel.maternp_covariance(x, y, p, c, pairwise)

    def tmean(x, param):
        return tgnp.ones((x.shape[0], 1))

    def tkernel(x, y, c, pairwise=False):
        return tgp.kernel.maternp_covariance(x, y, p, c, pairwise)

    return jgp.Model(jmean, jkernel), tgp.Model(tmean, tkernel)


def _quickstart():
    xt = tgp.misc.designs.regulargrid(1, 200, [[-1], [1]])
    xi = tgp.misc.designs.ldrandunif(1, 6, [[-1], [1]], seed=42)
    f = tgp.misc.testfunctions.twobumps
    return xi, f(xi), xt, f(xt), 3


def _example04():
    box = [[0.0] * 6, [1.0] * 6]
    xi = tgp.misc.designs.ldrandunif(6, 100, box, seed=0)
    xt = tgp.misc.designs.ldrandunif(6, 200, box, seed=1)
    f = tgp.misc.testfunctions.hartmann6
    return xi, f(xi), xt, f(xt), 2


def _relmax(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("case", [_quickstart, _example04], ids=["quickstart", "example04"])
def test_reml_fit_and_predict_match_jax(case):
    xi, zi, xt, zt, p = case()
    jm, tm = _models(p)
    jm, jinfo = jgp.kernel.select_parameters_with_reml(jm, xi, zi, info=True)
    tm, tinfo = tgp.kernel.select_parameters_with_reml(tm, xi, zi, info=True)

    jcov = np.asarray(jm.covparam)
    tcov = tgnp.to_np(tm.covparam)
    assert isinstance(tm.covparam, torch.Tensor)
    np.testing.assert_allclose(tinfo["covparam0"], np.asarray(jinfo["covparam0"]),
                               rtol=1e-10)
    np.testing.assert_allclose(tcov, jcov, rtol=0, atol=1e-3)
    assert abs(tinfo.fun - jinfo.fun) <= 1e-6 * abs(jinfo.fun)

    tzpm, tzpv = tm.predict(xi, zi, xt)
    rmse = float(np.sqrt(np.mean((tzpm - zt) ** 2)))
    assert rmse < float(np.std(zt))  # better than the constant predictor

    # predictions at one shared covparam (the JAX optimum)
    tm.covparam, _ = params_from_numpy(jcov, device="cpu", dtype=torch.float64)
    jzpm, jzpv = jm.predict(xi, zi, xt)
    tzpm, tzpv = tm.predict(xi, zi, xt)
    assert _relmax(tzpm, np.asarray(jzpm)) <= 1e-8
    assert _relmax(tzpv, np.asarray(jzpv)) <= 1e-8
    # interpolation at the data
    izpm, _ = tm.predict(xi, zi, xi)
    np.testing.assert_allclose(izpm, zi, atol=1e-6)


def test_ml_constant_mean_matches_jax():
    xi, zi, _, _, p = _quickstart()

    def jkernel(x, y, c, pairwise=False):
        return jgp.kernel.maternp_covariance(x, y, p, c, pairwise)

    def tkernel(x, y, c, pairwise=False):
        return tgp.kernel.maternp_covariance(x, y, p, c, pairwise)

    jm = jgp.Model(lambda x, m: m * jgnp.ones((x.shape[0], 1)), jkernel,
                   meantype="parameterized")
    tm = tgp.Model(lambda x, m: m * tgnp.ones((x.shape[0], 1)), tkernel,
                   meantype="parameterized")
    jm, jinfo = jgp.kernel.select_parameters_with_ml_constant_mean(jm, xi, zi, info=True)
    tm, tinfo = tgp.kernel.select_parameters_with_ml_constant_mean(tm, xi, zi, info=True)
    np.testing.assert_allclose(tgnp.to_np(tm.meanparam), np.asarray(jm.meanparam), atol=1e-3)
    np.testing.assert_allclose(tgnp.to_np(tm.covparam), np.asarray(jm.covparam), atol=1e-3)
    assert abs(tinfo.fun - jinfo.fun) <= 1e-6 * abs(jinfo.fun)


def test_non_pd_covariance_gives_inf_not_exception():
    xi, zi, _, _, _ = _quickstart()

    def indefinite(cov, eye):
        # Matern minus 2 K_00 I: not positive definite for any covparam
        def kernel(x, y, c, pairwise=False):
            K = cov(x, y, 2, c, pairwise)
            if (y is x or y is None) and not pairwise:
                K = K - 2.0 * K[0, 0] * eye(x.shape[0])
            return K
        return kernel

    tm = tgp.Model(lambda x, m: tgnp.ones((x.shape[0], 1)),
                   indefinite(tgp.kernel.maternp_covariance, tgnp.eye))
    jm = jgp.Model(lambda x, m: jgnp.ones((x.shape[0], 1)),
                   indefinite(jgp.kernel.maternp_covariance, jgnp.eye))
    p0 = np.array([0.0, 1.0])
    crit, crit_pre, crit_no_grad, grad = tgp.kernel.make_selection_criterion_with_gradient(
        tm, tgp.kernel.negative_log_restricted_likelihood, xi, zi)
    assert crit_pre(p0) == np.inf
    np.testing.assert_array_equal(grad(p0), np.zeros(2))
    assert crit_no_grad(p0) == np.inf
    jcrit = jgp.kernel.make_selection_criterion_with_gradient(
        jm, jgp.kernel.negative_log_restricted_likelihood, xi, zi)[1]
    assert jcrit(p0) == np.inf
    # the optimizer starts from +inf without raising
    tm, info = tgp.kernel.select_parameters_with_reml(tm, xi, zi, covparam0=p0, info=True)
    assert info.history_criterion[0] == np.inf


def _bench_model(gp, gnp):
    """bench.py's model: constant mean, Matern p=2 plus a noise variance."""

    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, param, pairwise=False):
        sigma2 = gnp.exp(param[0])
        loginvrho = param[2:]
        if y is x or y is None:
            if pairwise:
                return sigma2 * gnp.ones((x.shape[0],))
            K = gnp.scaled_distance(loginvrho, x, x)
            return sigma2 * gp.kernel.maternp_kernel(2, K) + (
                gnp.exp(param[1]) * gnp.eye(K.shape[0]))
        if pairwise:
            K = gnp.scaled_distance_elementwise(loginvrho, x, y)
        else:
            K = gnp.scaled_distance(loginvrho, x, y)
        return sigma2 * gp.kernel.maternp_kernel(2, K)

    return gp.Model(constant_mean, kernel)


@contextlib.contextmanager
def _mixed_engine():
    jax_set_chol_engine("mixed")
    config.set_chol_engine("mixed")
    try:
        yield
    finally:
        jax_set_chol_engine("auto")
        config.set_chol_engine("auto")


def test_noisy_regression_on_the_mixed_engine_matches_jax(monkeypatch):
    n, d = 256, 6
    rng = np.random.default_rng(7)
    xi = rng.uniform(size=(n, d))
    zi = np.sin(3 * xi[:, 0]) + 0.5 * np.cos(5 * xi[:, 1]) + 0.1 * rng.normal(size=n)
    xt = np.random.default_rng(8).uniform(size=(100, d))
    p0 = np.concatenate([[np.log(np.var(zi))], [2 * np.log(0.1) + np.log(np.var(zi))],
                         -np.log(np.std(xi, axis=0))])
    jm, tm = _bench_model(jgp, jgnp), _bench_model(tgp, tgnp)
    k4_calls = []
    monkeypatch.setattr(mixed, "factorization_residual_plain",
                        lambda *a, _f=mixed.factorization_residual_plain:
                        k4_calls.append(1) or _f(*a))

    reml = tgp.kernel.negative_log_restricted_likelihood
    tcrit = tgp.kernel.make_selection_criterion_with_gradient(tm, reml, xi, zi)
    v64, g64 = tcrit[1](p0), tcrit[3](p0)
    with _mixed_engine():
        jcrit = jgp.kernel.make_selection_criterion_with_gradient(
            jm, jgp.kernel.negative_log_restricted_likelihood, xi, zi)
        tcrit = tgp.kernel.make_selection_criterion_with_gradient(tm, reml, xi, zi)
        jv, jg = jcrit[1](p0), np.asarray(jcrit[3](p0))
        tv, tg = tcrit[1](p0), tcrit[3](p0)
        assert k4_calls  # the port's mixed engine ran
        assert abs(tv - jv) <= 1e-10 * abs(jv)
        np.testing.assert_allclose(tg, jg, rtol=1e-6)
        assert abs(tv - v64) <= 1e-6 * abs(v64)
        envelope = np.array([1e-3] + [1e-4] * (d + 1))
        assert np.all(np.abs(tg - g64) <= envelope * np.abs(g64))

        opts = {"maxiter": 15}
        jp, jinfo = jgp.kernel.autoselect_parameters(p0, jcrit[1], jcrit[3], info=True,
                                                     method_options=opts)
        tp, tinfo = tgp.kernel.autoselect_parameters(p0, tcrit[1], tcrit[3], info=True,
                                                     method_options=opts)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)
        assert abs(tinfo.fun - jinfo.fun) <= 1e-6 * abs(jinfo.fun)

        jm.covparam = jgnp.asarray(jp)
        tm.covparam, _ = params_from_numpy(jp, device="cpu", dtype=torch.float64)
        for t, j in zip(tm.loo(xi, zi), jm.loo(xi, zi)):
            assert _relmax(t.numpy(), np.asarray(j)) <= 1e-8
        tzpm, tzpv = tm.predict(xi, zi, xt)
        jzpm, jzpv = jm.predict(xi, zi, xt)
        assert _relmax(tzpm, np.asarray(jzpm)) <= 1e-8
        assert _relmax(tzpv, np.asarray(jzpv)) <= 1e-8
