# tests/test_torch_sample_paths.py
"""Conditional sample paths through the port against gpmp_tpu, on the CPU.

Draws cannot match bitwise (torch.Generator vs jax.random), so where the
two packages are compared the same numpy normals are patched into both
packages' ``randn``.  Tolerances, with their reasons (max |diff| / max |ref|):

- the f64 Cholesky factor and the symmetric root are unique: paths 1e-10;
- the mixed engine's sampling root rests on an f32 Cholesky.  torch's and
  XLA's f32 factorizations differ in their last bits, and two such roots
  differ by a rotation of order eps32 sqrt(cond K): roots and paths are
  held to 10 eps32 sqrt(cond K) (measured 3.9e-5 at cond 1e6, 3.2e-4 at
  cond 5.2e7), and each package's root to C C^T = K within 1e-8
  (tests/test_ops.py's bar), which is what makes the draws right;
- K8s's plain version against the JAX package's K - L L^T: 1e-14 of max|K|
  (f64 sums in another order);
- conditioning (a gather and one product): 1e-12;
- examples 10 and 11 at their own sizes (nt = 200): cond(K) is 4.5e10 on
  their 1-D grid, where the two packages' f64 Cholesky factors differ in
  their last rows by up to ~eps64 cond(K): paths and conditioned paths 1e-8
  (measured 4.4e-9), interpolation of the noise-free observations 1e-6;
- moments: empirical covariance of 4000 draws within 0.15 of K, as
  tests/test_core.py holds the JAX package.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.num as jgnp
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu.config import set_chol_engine as jax_set_chol_engine
from gpmp_tpu.ops.refine import sampling_sqrt as jax_sampling_sqrt
from gpmp_tpu_torch import config
from gpmp_tpu_torch.core import sample_paths as tsp
from gpmp_tpu_torch.ops import mixed, refine


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


@contextlib.contextmanager
def _engine(name):
    jax_set_chol_engine(name)
    config.set_chol_engine(name)
    try:
        yield
    finally:
        jax_set_chol_engine("auto")
        config.set_chol_engine("auto")


def _same_normals(monkeypatch, normals):
    """Both packages' randn hand out the same numpy normals."""
    monkeypatch.setattr(jgnp, "randn", lambda *shape: jnp.asarray(normals[: shape[0], : shape[1]]))
    monkeypatch.setattr(tgnp, "randn", lambda *shape, generator=None: torch.as_tensor(
        normals[: shape[0], : shape[1]]))


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return Q @ np.diag(np.logspace(0, -np.log10(cond), n)) @ Q.T


def _matern_model(gp, gnp, covparam, meantype="linear_predictor", p=2):
    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def parameterized_mean(x, param):
        return param[0] + param[1] * x[:, :1]

    def kernel(x, y, c, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, p, c, pairwise)

    if meantype == "parameterized":
        return gp.Model(parameterized_mean, kernel, np.array([0.3, -0.7]), covparam,
                        meantype="parameterized")
    return gp.Model(constant_mean, kernel, None, covparam)


# ---------------------------------------------------------------------------
# the RNG shim
# ---------------------------------------------------------------------------
def test_rng_shim_determinism_dtype_device_and_generator():
    tgnp.set_seed(11)
    a, u = tgnp.randn(4, 3), tgnp.rand(5)
    tgnp.set_seed(11)
    assert torch.equal(tgnp.randn(4, 3), a) and torch.equal(tgnp.rand(5), u)
    assert not torch.equal(tgnp.randn(4, 3), a)  # the stream moves on
    assert a.dtype == u.dtype == tgnp.get_dtype() and a.device.type == "cpu"
    assert bool(((u >= 0) & (u < 1)).all())
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(tgnp.randn(3, 2, generator=g1), tgnp.randn((3, 2), generator=g2))
    c = tgnp.choice(7, size=(2, 3), replace=False, generator=g1)
    assert c.shape == (2, 3) and len(set(c.reshape(-1).tolist())) == 6
    w = tgnp.choice(np.array([1.0, 2.0, 3.0]), size=50, p=[0.0, 0.0, 1.0])
    assert torch.equal(w, torch.full((50,), 3.0, dtype=torch.float64))
    assert sorted(tgnp.permutation(6).tolist()) == list(range(6))
    rows = tgnp.permutation(np.arange(8.0).reshape(4, 2))
    assert sorted(rows[:, 0].tolist()) == [0.0, 2.0, 4.0, 6.0]
    assert tgnp.arange(5).dtype == torch.int64


# ---------------------------------------------------------------------------
# the sampling root (K5, K8s plain versions)
# ---------------------------------------------------------------------------
def test_k8s_sampling_residual_plain_matches_jax():
    n = 260
    K = _spd(n, 1e4, 3)
    L32, _ = mixed._f32_preconditioner(torch.as_tensor(K))
    E = refine.sampling_residual_plain(torch.as_tensor(K), L32).numpy()
    L = L32.double().numpy()
    Ej = np.asarray(jax.jit(lambda K, L: K - L @ L.T)(K, L))
    assert E.dtype == np.float64 and np.array_equal(E, E.T)
    assert np.max(np.abs(E - Ej)) <= 1e-14 * np.max(np.abs(K))
    assert refine.K8S_LAUNCHES == 0


@pytest.mark.parametrize("n,cond", [(300, 1e2), (256, 1e6)])
def test_sampling_sqrt_matches_jax(n, cond):
    K = _spd(n, cond, seed=int(math.log10(cond)))
    C = refine.sampling_sqrt(torch.as_tensor(K)).numpy()
    Cj = np.asarray(jax.jit(jax_sampling_sqrt)(jnp.asarray(K)))
    for root in (C, Cj):
        assert np.linalg.norm(root @ root.T - K) / np.linalg.norm(K) < 1e-8
    assert _rel(C, Cj) <= 10 * np.finfo(np.float32).eps * math.sqrt(cond)
    bad = refine.sampling_sqrt(-torch.eye(64, dtype=torch.float64))
    assert torch.isnan(bad).any()


# ---------------------------------------------------------------------------
# sample_paths and conditioning against gpmp_tpu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["chol", "svd"])
@pytest.mark.parametrize("engine", ["f64", "mixed"])
def test_sample_paths_match_jax(monkeypatch, engine, method):
    """nt = 200 (above the mixed engine's gate) in d = 2, 7 paths."""
    rng = np.random.default_rng(21)
    xt = rng.uniform(size=(200, 2))
    covparam = np.array([math.log(0.8), math.log(1 / 0.4), math.log(1 / 0.6)])
    normals = rng.normal(size=(200, 7))
    _same_normals(monkeypatch, normals)
    before = dict(tsp.BRANCHES)
    with _engine(engine):
        zj = np.asarray(_matern_model(jgp, jgnp, jnp.asarray(covparam)).sample_paths(
            xt, 7, method=method))
        zt = _matern_model(tgp, tgnp, covparam).sample_paths(xt, 7, method=method)
    assert zt.shape == (200, 7) and zt.dtype == torch.float64
    tol = 1e-10
    if (engine, method) == ("mixed", "chol"):
        K = _matern_model(tgp, tgnp, covparam).covariance(
            torch.as_tensor(xt), None, torch.as_tensor(covparam)).numpy()
        lam = np.linalg.eigvalsh(K)
        tol = 10 * np.finfo(np.float32).eps * math.sqrt(lam[-1] / lam[0])
        C = refine.sampling_sqrt(torch.as_tensor(K)).numpy()
        assert np.linalg.norm(C @ C.T - K) / np.linalg.norm(K) < 1e-8
    assert _rel(zt.numpy(), zj) <= tol
    branch = {"chol": "cholesky" if engine == "f64" else "sampling_sqrt", "svd": "svd"}[method]
    assert tsp.BRANCHES[branch] == before[branch] + 1


def test_sample_paths_fallback_and_check_result(monkeypatch):
    """A NaN sampling root falls back to the f64 factor (counted); a failed
    factor raises the reference's AssertionError unless told not to check."""
    n = 200
    K = torch.as_tensor(_spd(n, 1e3, 5))
    monkeypatch.setattr(refine, "sampling_sqrt", lambda K: torch.full_like(K, torch.nan))
    before = tsp.BRANCHES["fallback"]
    with _engine("mixed"):
        C = tsp.sampling_factor(K)
    assert tsp.BRANCHES["fallback"] == before + 1
    np.testing.assert_array_equal(C.numpy(), torch.linalg.cholesky(K).numpy())
    with pytest.raises(AssertionError, match="Cholesky factorization failed"):
        tsp.sampling_factor(-K)
    assert torch.isnan(tsp.sampling_factor(-K, check_result=False)).all()
    with pytest.raises(ValueError, match="chol' or 'svd"):
        tsp.sampling_factor(K, method="qr")


@pytest.mark.parametrize("meantype", ["linear_predictor", "parameterized"])
def test_conditional_sample_paths_match_jax(meantype):
    rng = np.random.default_rng(31)
    xt = np.linspace(0, 1, 40).reshape(-1, 1)
    xi_ind = np.array([3, 11, 20, 33])
    xi, zi = xt[xi_ind], np.sin(6 * xt[xi_ind, 0])
    ztsim = rng.normal(size=(40, 5))
    covparam = np.array([0.1, math.log(1 / 0.3)])
    jm = _matern_model(jgp, jgnp, jnp.asarray(covparam), meantype)
    tm = _matern_model(tgp, tgnp, covparam, meantype)
    lam_j = jm.predict(xi, zi, xt, return_lambdas=True)[2]
    lam_t = tm.predict(xi, zi, xt, return_lambdas=True)[2]
    if meantype == "parameterized":
        args = (ztsim, xi, xi_ind, zi, xt, np.arange(40))
        zj = jm.conditional_sample_paths_parameterized_mean(*args, lam_j)
        zt = tm.conditional_sample_paths_parameterized_mean(*args, lam_t)
        ztt = tm.conditional_sample_paths_parameterized_mean(*args, lam_t, convert_out=False)
    else:
        args = (ztsim, xi_ind, zi, tgnp.arange(40))
        zj = jm.conditional_sample_paths(ztsim, xi_ind, zi, np.arange(40), lam_j)
        zt = tm.conditional_sample_paths(*args, lam_t)
        ztt = tm.conditional_sample_paths(*args, lam_t, convert_out=False)
    assert isinstance(zt, np.ndarray) and isinstance(ztt, torch.Tensor)
    assert _rel(zt, np.asarray(zj)) <= 1e-12
    if meantype == "linear_predictor":  # conditioned paths interpolate
        np.testing.assert_allclose(zt[xi_ind], np.tile(zi[:, None], (1, 5)), atol=1e-6)


# ---------------------------------------------------------------------------
# examples 10 and 11, and the moments
# ---------------------------------------------------------------------------
def _example11_kernel(gp, gnp):
    """examples/gpmp_tpu_example11's kernel: the per-point noise variance
    travels as the last input column and is added on the same-set diagonal."""
    def kernel(x, y, covparam, pairwise=False):
        sigma2, loginvrho = gnp.exp(covparam[0]), covparam[1:]
        if y is x or y is None:
            xc, nv = x[:, :-1], x[:, -1].reshape(-1)
            if pairwise:
                return sigma2 * gnp.ones((xc.shape[0],)) + nv
            D = gnp.scaled_distance(loginvrho, xc, xc)
            return sigma2 * gp.kernel.maternp_kernel(2, D) + gnp.diag(nv)
        xc, yc = x[:, :-1], y[:, :-1]
        D = (gnp.scaled_distance_elementwise(loginvrho, xc, yc) if pairwise
             else gnp.scaled_distance(loginvrho, xc, yc))
        return sigma2 * gp.kernel.maternp_kernel(2, D)

    return kernel


@pytest.mark.parametrize("example", [10, 11])
def test_examples_10_and_11_flows_match_jax(monkeypatch, example):
    """The examples' flow (prior paths on nt = 200, kriging weights, paths
    conditioned on 5 observations) through both packages, same normals."""
    import importlib

    mod = importlib.import_module(
        "examples.gpmp_tpu_example10_sample_paths" if example == 10
        else "examples.gpmp_tpu_example11_sample_paths_noisy_obs")
    normals = np.random.default_rng(example).normal(size=(200, 6))
    _same_normals(monkeypatch, normals)
    ztsim_j, ztsimc_j = mod.main(n_paths=6, seed=0)

    covparam = np.array([math.log(0.5**2), math.log(1 / 0.7)])
    if example == 10:
        xt, _zt, xi, zi, xi_ind = mod.generate_data()
        xt_f, xi_f, exact = xt, xi, list(range(5))
        model = _matern_model(tgp, tgnp, covparam)
    else:
        xt, _zt, xi, zi, xi_ind, noise_var = mod.generate_data(0)
        xi_f = mod.with_noise_column(xi, noise_var)
        xt_f = mod.with_noise_column(xt, 0.0)
        exact = list(np.flatnonzero(noise_var == 0.0))  # noise-free observations
        model = tgp.Model(lambda x, p: tgnp.ones((x.shape[0], 1)),
                          _example11_kernel(tgp, tgnp), None, covparam)
    tgnp.set_seed(0)
    ztsim = model.sample_paths(xt_f, 6)
    _zpm, _zpv, lam = model.predict(xi_f, zi, xt_f, return_lambdas=True)
    ztsimc = model.conditional_sample_paths(ztsim, np.asarray(xi_ind), zi,
                                            np.arange(xt.shape[0]), lam)
    assert _rel(ztsim.numpy(), np.asarray(ztsim_j)) <= 1e-8
    assert _rel(ztsimc, np.asarray(ztsimc_j)) <= 1e-8
    np.testing.assert_allclose(ztsimc[np.asarray(xi_ind)[exact]],
                               np.tile(zi[exact, None], (1, 6)), atol=1e-6)


def test_sample_paths_moments():
    """As tests/test_core.py:269 holds the JAX package: 4000 draws on a
    30-point grid, zero mean, empirical covariance within 0.15 of K."""
    covparam = np.array([0.0, math.log(1 / 0.3)])
    model = tgp.Model(None, lambda x, y, c, pairwise=False: tgp.kernel.maternp_covariance(
        x, y, 2, c, pairwise), covparam=covparam, meantype="zero")
    xt = np.linspace(0, 1, 30).reshape(-1, 1)
    tgnp.set_seed(0)
    paths = model.sample_paths(xt, 4000).numpy()
    K = tgp.kernel.maternp_covariance(torch.as_tensor(xt), None, 2,
                                      torch.as_tensor(covparam)).numpy()
    np.testing.assert_allclose(paths @ paths.T / 4000, K, atol=0.15)
    assert np.max(np.abs(paths.mean(axis=1))) < 0.1
