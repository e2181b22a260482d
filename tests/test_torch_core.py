# tests/test_torch_core.py
"""core (likelihoods, norms, kriging) of the port against gpmp_tpu.

One evaluation each at n in {6, 200, 1000}, d=3, Matern p=2, on the same
numpy data and parameters (crossed with interop.params_from_numpy).
Tolerances (both sides exact f64 Cholesky on the CPU): criterion values
rel 1e-10, gradients rel 1e-8 (max |diff| / max |grad|), norms rel 1e-10,
predicted mean and variance rel 1e-8 (max |diff| / max |value|).  The
'contrast' REML goes through a complete QR, which torch cannot
differentiate, so it is compared by value only.

LOO (zloo, sigma2loo, eloo) is compared for the three mean types on both
Cholesky engines, with a noise-variance kernel (bench.py's) at n=200 (above
the mixed engine's n >= 192 gate): rel 1e-10 on the f64 engine, rel 1e-8 on
the mixed engine (refined solves and an f32-corrected diagonal on both
sides, ~1e-12 apart in practice).
"""

import contextlib

import functools

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.num as jgnp
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu.config import set_chol_engine as jax_set_chol_engine
from gpmp_tpu_torch.interop import params_from_numpy
from gpmp_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)

SIZES = [6, 200, 1000]
P = 2


@functools.lru_cache(maxsize=None)
def _data(n):
    rng = np.random.default_rng(n)
    d = 3
    xi = rng.uniform(size=(n, d))
    zi = np.sin(3 * xi[:, 0]) + np.cos(5 * xi[:, 1]) + xi[:, 2] ** 2
    xt = rng.uniform(size=(50, d))
    covparam = np.array([np.log(0.8), np.log(1 / 0.3), np.log(1 / 0.2), np.log(1 / 0.4)])
    meanparam = np.array([0.4])
    return xi, zi, xt, covparam, meanparam


def _jax_model(meantype, covparam, meanparam):
    def kernel(x, y, c, pairwise=False):
        return jgp.kernel.maternp_covariance(x, y, P, c, pairwise)

    def mean(x, param):
        if meantype == "parameterized":
            return param * jgnp.ones((x.shape[0], 1))
        return jgnp.ones((x.shape[0], 1))

    return jgp.Model(None if meantype == "zero" else mean, kernel,
                     meanparam=None if meanparam is None else jgnp.asarray(meanparam),
                     covparam=jgnp.asarray(covparam), meantype=meantype)


def _torch_model(meantype, covparam, meanparam):
    def kernel(x, y, c, pairwise=False):
        return tgp.kernel.maternp_covariance(x, y, P, c, pairwise)

    def mean(x, param):
        if meantype == "parameterized":
            return param * tgnp.ones((x.shape[0], 1))
        return tgnp.ones((x.shape[0], 1))

    cp, mp = params_from_numpy(covparam, meanparam, device="cpu", dtype=torch.float64)
    return tgp.Model(None if meantype == "zero" else mean, kernel, meanparam=mp,
                     covparam=cp, meantype=meantype)


def _relmax(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _torch_value_grad(fn, p):
    pt = torch.as_tensor(p).clone().requires_grad_(True)
    v = fn(pt)
    (g,) = torch.autograd.grad(v, pt)
    return float(v.detach()), g.numpy()


def _check_value_grad(tv, tg, jv, jg):
    assert np.isfinite(tv) and np.isfinite(jv)
    assert abs(tv - jv) <= 1e-10 * abs(jv)
    assert _relmax(tg, jg) <= 1e-8


@pytest.mark.parametrize("n", SIZES)
def test_nll_zero_mean_value_and_grad(n):
    xi, zi, _, cp, _ = _data(n)
    jm, tm = _jax_model("zero", cp, None), _torch_model("zero", cp, None)
    xj, zj = jgnp.asarray(xi), jgnp.asarray(zi)
    xt_, zt_ = tgnp.asarray(xi), tgnp.asarray(zi)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda c: jm.negative_log_likelihood_zero_mean(c, xj, zj)))(jgnp.asarray(cp))
    tv, tg = _torch_value_grad(
        lambda c: tm.negative_log_likelihood_zero_mean(c, xt_, zt_), cp)
    _check_value_grad(tv, tg, float(jv), np.asarray(jg))


@pytest.mark.parametrize("n", SIZES)
def test_nll_parameterized_mean_value_and_grad(n):
    xi, zi, _, cp, mp = _data(n)
    jm, tm = _jax_model("parameterized", cp, mp), _torch_model("parameterized", cp, mp)
    xj, zj = jgnp.asarray(xi), jgnp.asarray(zi)
    xt_, zt_ = tgnp.asarray(xi), tgnp.asarray(zi)
    theta = np.concatenate([mp, cp])
    jv, jg = jax.jit(jax.value_and_grad(
        lambda t: jm.negative_log_likelihood(t[:1], t[1:], xj, zj)))(jgnp.asarray(theta))
    tv, tg = _torch_value_grad(
        lambda t: tm.negative_log_likelihood(t[:1], t[1:], xt_, zt_), theta)
    _check_value_grad(tv, tg, float(jv), np.asarray(jg))


@pytest.mark.parametrize("n", SIZES)
def test_reml_profiled_value_and_grad(n):
    xi, zi, _, cp, _ = _data(n)
    jm, tm = _jax_model("linear_predictor", cp, None), _torch_model("linear_predictor", cp, None)
    xj, zj = jgnp.asarray(xi), jgnp.asarray(zi)
    xt_, zt_ = tgnp.asarray(xi), tgnp.asarray(zi)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda c: jm.negative_log_restricted_likelihood(c, xj, zj)))(jgnp.asarray(cp))
    tv, tg = _torch_value_grad(
        lambda c: tm.negative_log_restricted_likelihood(c, xt_, zt_), cp)
    _check_value_grad(tv, tg, float(jv), np.asarray(jg))


@pytest.mark.parametrize("n", SIZES)
def test_reml_contrast_value(n):
    xi, zi, _, cp, _ = _data(n)
    jm, tm = _jax_model("linear_predictor", cp, None), _torch_model("linear_predictor", cp, None)
    xj, zj = jgnp.asarray(xi), jgnp.asarray(zi)
    jv = float(jax.jit(lambda c: jm.negative_log_restricted_likelihood(
        c, xj, zj, impl="contrast"))(jgnp.asarray(cp)))
    tv = float(tm.negative_log_restricted_likelihood(
        tgnp.asarray(cp), tgnp.asarray(xi), tgnp.asarray(zi), impl="contrast"))
    assert np.isfinite(tv) and abs(tv - jv) <= 1e-10 * abs(jv)
    # and the two REML implementations agree with each other
    tp = float(tm.negative_log_restricted_likelihood(
        tgnp.asarray(cp), tgnp.asarray(xi), tgnp.asarray(zi)))
    assert abs(tp - tv) <= 1e-8 * abs(tv)


@pytest.mark.parametrize("n", SIZES)
def test_norms_match_jax(n):
    xi, zi, _, cp, _ = _data(n)
    jm, tm = _jax_model("linear_predictor", cp, None), _torch_model("linear_predictor", cp, None)
    xj, zj, cj = jgnp.asarray(xi), jgnp.asarray(zi), jgnp.asarray(cp)
    xt_, zt_, ct = tgnp.asarray(xi), tgnp.asarray(zi), tgnp.asarray(cp)
    jax_norms = jax.jit(lambda c: (
        jm.norm_k_sqrd(xj, zj, c), jm.norm_k_sqrd(xj, zj.reshape(-1, 1), c),
        jm.norm_k_sqrd_with_zero_mean(xj, zj, c), *jm.k_inverses(xj, zj, c)))(cj)
    torch_norms = (tm.norm_k_sqrd(xt_, zt_, ct), tm.norm_k_sqrd(xt_, zt_.reshape(-1, 1), ct),
                   tm.norm_k_sqrd_with_zero_mean(xt_, zt_, ct), *tm.k_inverses(xt_, zt_, ct))
    pairs = list(zip(torch_norms, jax_norms))
    for t, j in pairs:
        assert tuple(t.shape) == tuple(j.shape)
        assert _relmax(t.numpy(), np.asarray(j)) <= 1e-10


@pytest.mark.parametrize("meantype", ["zero", "parameterized", "linear_predictor"])
@pytest.mark.parametrize("n", SIZES)
def test_predict_matches_jax(n, meantype):
    xi, zi, xt, cp, mp = _data(n)
    mp_ = mp if meantype == "parameterized" else None
    jm, tm = _jax_model(meantype, cp, mp_), _torch_model(meantype, cp, mp_)
    jzpm, jzpv = jm.predict(xi, zi, xt)
    tzpm, tzpv = tm.predict(xi, zi, xt)
    assert isinstance(tzpm, np.ndarray) and tzpm.shape == (50,) and tzpv.shape == (50,)
    assert _relmax(tzpm, jzpm) <= 1e-8
    assert _relmax(tzpv, jzpv) <= 1e-8


@pytest.mark.parametrize("method", ["nullspace", "block"])
def test_universal_kriging_routes_agree(method):
    from gpmp_tpu_torch.core import kriging

    xi, _, xt, cp, _ = _data(200)
    tm = _torch_model("linear_predictor", cp, None)
    xi_t, xt_t = tgnp.asarray(xi), tgnp.asarray(xt)
    lam, var = kriging.kriging_predictor(tm, xi_t, xt_t)
    if method == "block":
        lam2, var2 = kriging.kriging_predictor_block(tm, xi_t, xt_t)
    else:
        lam2, var2 = kriging.kriging_predictor(tm, xi_t, xt_t, method="nullspace")
    assert _relmax(lam2.numpy(), lam.numpy()) <= 1e-7
    assert _relmax(var2.numpy(), var.numpy()) <= 1e-7


def _noisy_kernel(gp, gnp):
    """bench.py's user kernel: covparam [log s2, log noise, log 1/rho_1..d]."""

    def kernel(x, y, c, pairwise=False):
        sigma2 = gnp.exp(c[0])
        if y is x or y is None:
            if pairwise:
                return sigma2 * gnp.ones((x.shape[0],))
            K = gnp.scaled_distance(c[2:], x, x)
            return sigma2 * gp.kernel.maternp_kernel(P, K) + gnp.exp(c[1]) * gnp.eye(
                K.shape[0])
        if pairwise:
            return sigma2 * gp.kernel.maternp_kernel(
                P, gnp.scaled_distance_elementwise(c[2:], x, y))
        return sigma2 * gp.kernel.maternp_kernel(P, gnp.scaled_distance(c[2:], x, y))

    return kernel


@contextlib.contextmanager
def _engine(name):
    jax_set_chol_engine(name)
    config.set_chol_engine(name)
    try:
        yield
    finally:
        jax_set_chol_engine("auto")
        config.set_chol_engine("auto")


@pytest.mark.parametrize("engine", ["f64", "mixed"])
@pytest.mark.parametrize("meantype", ["zero", "parameterized", "linear_predictor"])
def test_loo_matches_jax(meantype, engine):
    xi, zi, _, cp, mp = _data(200)
    cp = np.concatenate([cp[:1], [np.log(1e-2)], cp[1:]])
    mp_ = mp if meantype == "parameterized" else None

    def mean(gnp):
        def m(x, param):
            if meantype == "parameterized":
                return param * gnp.ones((x.shape[0], 1))
            return gnp.ones((x.shape[0], 1))
        return None if meantype == "zero" else m

    jm = jgp.Model(mean(jgnp), _noisy_kernel(jgp, jgnp),
                   meanparam=None if mp_ is None else jgnp.asarray(mp_),
                   covparam=jgnp.asarray(cp), meantype=meantype)
    tcp, tmp = params_from_numpy(cp, mp_, device="cpu", dtype=torch.float64)
    tm = tgp.Model(mean(tgnp), _noisy_kernel(tgp, tgnp), meanparam=tmp, covparam=tcp,
                   meantype=meantype)
    with _engine(engine):
        jl = jm.loo(xi, zi)
        tl = tm.loo(xi, zi)
    tol = 1e-10 if engine == "f64" else 1e-8
    for t, j in zip(tl, jl):
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == (200,)
        assert _relmax(t.numpy(), np.asarray(j)) <= tol
    zloo, sigma2loo, eloo = tm.loo(xi, zi, convert_out=True)
    assert isinstance(zloo, np.ndarray) and np.all(sigma2loo > 0)
