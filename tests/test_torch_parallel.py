# tests/test_torch_parallel.py
"""The resident one-card mesh path of the port (gpmp_tpu_torch.parallel: the
sharded REML on the blocked Cholesky and on the sharded mixed engine,
sharded predict, LOO, kriging weights and sample paths, the model view)
against gpmp_tpu.parallel on its one-device mesh, both in float64 on the
CPU, on the same numpy inputs: bench_large_n.py's model (Matern p = 2 plus a
noise variance, constant mean) at n = 512, d = 3, panels of 128.

The kernels run only on a CUDA card; here their plain versions run.
Tolerances, each with its reason:

- the f64 branch (both sides the same exact blocked algorithm): REML value
  and gradient, predict, LOO and kriging weights rel 1e-12 (the gradient,
  which passes through the gram's pullback too, 1e-10);
- the mixed branch: tests/test_torch_streamed.py's bars, the REML value to
  1e-8 and the gradient within the class envelope (rtol 1e-3, atol 1e-6
  max|g|): f32 preconditioners and f32 backward products in another order;
- the view against Model.predict / Model.loo (the core f64 engine, another
  factorization): 1e-10;
- sample paths: the factor's own draws exactly (L eps from the same
  generator), and the empirical covariance of 20000 paths within 5 standard
  errors of K.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.config as jconfig
import gpmp_tpu.num as jgnp
from gpmp_tpu.parallel import make_mesh as jmake_mesh
from gpmp_tpu.parallel.likelihood import (
    sharded_negative_log_restricted_likelihood as j_sharded_reml,
)
from gpmp_tpu.parallel.loo import sharded_loo as j_sharded_loo
from gpmp_tpu.parallel.predict import (
    sharded_kriging_weights as j_kriging_weights,
    sharded_predict as j_sharded_predict,
)
import gpmp_tpu.parallel.mixed as jpmixed

import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.parallel import (
    ShardedModelView,
    make_mesh,
    mixed as tpmixed,
    sharded_cholesky,
    sharded_covariance,
    sharded_kriging_weights,
    sharded_loo,
    sharded_negative_log_restricted_likelihood,
    sharded_predict,
    sharded_sample_paths,
)

N, D, BLOCK, NT = 512, 3, 128, 24


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _kernel_for(gp, gnp):
    def kernel(x, y, param, pairwise=False):
        sigma2, noise, loginvrho = gnp.exp(param[0]), gnp.exp(param[1]), param[2:]
        if y is x or y is None:
            if pairwise:
                return (sigma2 + noise) * gnp.ones((x.shape[0],))
            Dm = gnp.scaled_distance(loginvrho, x, x)
            return sigma2 * gp.kernel.maternp_kernel(2, Dm) + noise * gnp.eye(Dm.shape[0])
        Dm = (gnp.scaled_distance_elementwise if pairwise
              else gnp.scaled_distance)(loginvrho, x, y)
        return sigma2 * gp.kernel.maternp_kernel(2, Dm)

    return kernel


def _models(meantype="linear_predictor", covparam=None):
    def mean(gnp):
        if meantype == "zero":
            return None
        if meantype == "parameterized":
            return lambda x, p: 0.3 * gnp.ones((x.shape[0], 1))
        return lambda x, p: gnp.ones((x.shape[0], 1))

    return (jgp.Model(mean(jgnp), _kernel_for(jgp, jgnp), covparam=covparam, meantype=meantype),
            tgp.Model(mean(tgnp), _kernel_for(tgp, tgnp), covparam=covparam, meantype=meantype))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def data():
    """bench_large_n.py's make_data at n = 512 (its xt: NT points)."""
    rng = np.random.default_rng(20260817)
    xi = rng.uniform(size=(N, D))
    zi = (np.sin(3.0 * xi[:, 0]) + 0.5 * xi[:, 1] + 0.25 * xi[:, 2] ** 2
          + 0.05 * rng.normal(size=N))
    xt = rng.uniform(size=(NT, D))
    p0 = np.concatenate([[np.log(np.var(zi))], [np.log(1e-2)], -np.log(np.std(xi, axis=0))])
    return xi, zi, xt, p0


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(1, axis_name="shard")


@pytest.fixture
def engine():
    """Sets both packages' Cholesky engine; restores them after."""
    prev_t, prev_j = config.get_chol_engine(), jconfig.get_chol_engine()

    def set_engine(name):
        config.set_chol_engine(name)
        jconfig.set_chol_engine(name)

    yield set_engine
    config.set_chol_engine(prev_t)
    jconfig.set_chol_engine(prev_j)


def _port_reml_vg(model, xi, zi, p, mesh, block=BLOCK):
    pt = _t(p).clone().requires_grad_(True)
    v = sharded_negative_log_restricted_likelihood(model, pt, _t(xi), _t(zi), mesh, block=block)
    (g,) = torch.autograd.grad(v, pt)
    return float(v.detach()), g.numpy()


def _jax_reml_vg(jmodel, xi, zi, p, jmesh, block=BLOCK):
    fn = jax.jit(jax.value_and_grad(lambda q: j_sharded_reml(
        jmodel, q, jnp.asarray(xi), jnp.asarray(zi), jmesh, block=block)))
    v, g = fn(jnp.asarray(p))
    return float(v), np.asarray(g)


# ---------------------------------------------------------------------------
# the sharded REML on both engines
# ---------------------------------------------------------------------------
def test_sharded_reml_f64_matches_jax(data, jmesh, engine):
    """The exact f64 branch: blocked factor with refined panels, the solves'
    adjoints and Murray's backward, against jax.value_and_grad."""
    xi, zi, _xt, p0 = data
    engine("f64")
    jmodel, tmodel = _models()
    v, g = _port_reml_vg(tmodel, xi, zi, p0, make_mesh(1, axis_name="shard"))
    vj, gj = _jax_reml_vg(jmodel, xi, zi, p0, jmesh)
    assert abs(v - vj) <= 1e-12 * abs(vj)
    assert _rel(g, gj) <= 1e-10


@pytest.mark.parametrize("branch", ["series", "robust"])
def test_sharded_reml_mixed_matches_jax(data, jmesh, engine, monkeypatch, branch):
    """The sharded mixed engine (n < 8192: the blocked f32 inverse) on its
    series branch, and on its robust branch with the series gate shut in
    both packages."""
    xi, zi, _xt, p0 = data
    engine("mixed")
    if branch == "robust":
        monkeypatch.setattr(tpmixed, "_SERIES_TAU", 0.0)
        monkeypatch.setattr(jpmixed, "_SERIES_TAU", 0.0)
    calls = []
    core = tpmixed._mp_core
    monkeypatch.setattr(tpmixed, "_mp_core",
                        lambda *a: calls.append(1) or core(*a))
    jmodel, tmodel = _models()
    v, g = _port_reml_vg(tmodel, xi, zi, p0, make_mesh(1, axis_name="shard"))
    vj, gj = _jax_reml_vg(jmodel, xi, zi, p0, jmesh)
    assert calls  # the resident mixed branch ran
    assert abs(v - vj) <= 1e-8 * abs(vj)
    np.testing.assert_allclose(g, gj, rtol=1e-3, atol=1e-6 * np.max(np.abs(gj)))


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_mixed_divergent_second_level_is_refused(data, engine, monkeypatch, eps):
    """The robust branch gates its second level on rms(G) <= 1e-6 (the
    streamed engine's gate, looser than the JAX module's absolute
    |G|_F^2 < 1e-8): a second-level inverse MF perturbed by eps per entry,
    G ~ eps, still makes the REML +inf."""
    xi, zi, _xt, p0 = data
    engine("mixed")
    monkeypatch.setattr(tpmixed, "_SERIES_TAU", 0.0)
    _jmodel, tmodel = _models()
    mesh = make_mesh(1, axis_name="shard")

    def reml():
        return float(sharded_negative_log_restricted_likelihood(
            tmodel, _t(p0), _t(xi), _t(zi), mesh, block=BLOCK))

    assert np.isfinite(reml())
    pair = tpmixed._plain_f32_tri_pair

    def divergent(E32):
        F, MF = pair(E32)
        gen = torch.Generator().manual_seed(0)
        return F, MF + eps * torch.randn(MF.shape, generator=gen, dtype=MF.dtype)

    monkeypatch.setattr(tpmixed, "_plain_f32_tri_pair", divergent)
    assert reml() == float("inf")


# ---------------------------------------------------------------------------
# predict, LOO, kriging weights, sample paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("meantype", ["zero", "parameterized", "linear_predictor"])
def test_sharded_predict_matches_jax(data, jmesh, meantype):
    xi, zi, xt, p0 = data
    jmodel, tmodel = _models(meantype, covparam=p0)
    mesh = make_mesh(1, axis_name="shard")
    zpm, zpv = sharded_predict(tmodel, xi, zi, xt, mesh, block=BLOCK)
    zpm_j, zpv_j = jax.jit(lambda a, b, c: j_sharded_predict(
        jmodel, a, b, c, jmesh, block=BLOCK))(xi, zi, xt)
    assert _rel(zpm.numpy(), zpm_j) <= 1e-12
    assert _rel(zpv.numpy(), zpv_j) <= 1e-12
    if meantype == "linear_predictor":
        # factor=: predict after fit costs the solves only, same values
        L = sharded_cholesky(sharded_covariance(tmodel, _t(p0), _t(xi), mesh), mesh,
                             block=BLOCK)
        zpm_f, zpv_f = sharded_predict(tmodel, xi, zi, xt, mesh, block=BLOCK, factor=L)
        assert torch.equal(zpm_f, zpm) and torch.equal(zpv_f, zpv)


@pytest.mark.parametrize("meantype", ["zero", "linear_predictor"])
def test_sharded_loo_matches_jax(data, jmesh, meantype):
    xi, zi, _xt, p0 = data
    jmodel, tmodel = _models(meantype, covparam=p0)
    out = sharded_loo(tmodel, xi, zi, make_mesh(1, axis_name="shard"), block=BLOCK)
    ref = jax.jit(lambda a, b: j_sharded_loo(jmodel, a, b, jmesh, block=BLOCK))(xi, zi)
    for a, b in zip(out, ref):
        assert _rel(a.numpy(), b) <= 1e-12


def test_sharded_kriging_weights_matches_jax(data, jmesh):
    xi, _zi, xt, p0 = data
    jmodel, tmodel = _models(covparam=p0)
    lam = sharded_kriging_weights(tmodel, xi, xt, make_mesh(1, axis_name="shard"), block=BLOCK)
    lam_j = jax.jit(lambda a, b: j_kriging_weights(jmodel, a, b, jmesh, block=BLOCK))(xi, xt)
    assert lam.shape == (N, NT) and _rel(lam.numpy(), lam_j) <= 1e-12


def test_sharded_sample_paths_by_moments(data):
    """L eps with eps from the caller's generator: the paths are the factor's
    own draws, and their empirical covariance matches K."""
    xi, _zi, _xt, p0 = data
    _jm, tmodel = _models(covparam=p0)
    xs = xi[:128]
    mesh = make_mesh(1, axis_name="shard")
    m = 20000
    Z = sharded_sample_paths(tmodel, xs, m, mesh, block=64,
                             generator=torch.Generator().manual_seed(3))
    K = sharded_covariance(tmodel, _t(p0), _t(xs), mesh)
    L = sharded_cholesky(K, mesh, block=64)
    eps = tgnp.randn(128, m, generator=torch.Generator().manual_seed(3))
    assert torch.equal(Z, L @ eps)
    C = (Z @ Z.T / m).numpy()
    Kn = K.numpy()
    se = np.sqrt((Kn ** 2 + np.outer(np.diag(Kn), np.diag(Kn))) / m)
    assert np.all(np.abs(C - Kn) <= 5 * se + 1e-12)


def test_view_predict_loo_match_model(data, engine):
    """The view's predict and LOO (the blocked factor, auto panels of 512)
    against Model.predict / Model.loo on the core f64 engine."""
    xi, zi, xt, p0 = data
    engine("f64")
    _jm, tmodel = _models(covparam=p0)
    view = ShardedModelView(tmodel, make_mesh(1, axis_name="shard"))
    zpm, zpv = view.predict(xi, zi, xt)
    zpm0, zpv0 = tmodel.predict(xi, zi, xt, convert_out=False)
    assert _rel(zpm.numpy(), zpm0.numpy()) <= 1e-10
    assert _rel(zpv.numpy(), zpv0.numpy()) <= 1e-10
    for a, b in zip(view.loo(xi, zi), tmodel.loo(xi, zi)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-10
    with pytest.raises(NotImplementedError, match="return_lambdas"):
        view.predict(xi, zi, xt, return_lambdas=True)


def test_factor_refuses_gradient(data, engine):
    """REML and predict from a precomputed factor= give the values; a
    covparam gradient through them raises."""
    xi, zi, xt, p0 = data
    engine("f64")
    _jm, tmodel = _models(covparam=p0)
    mesh = make_mesh(1, axis_name="shard")
    x, z = _t(xi), _t(zi)
    L = sharded_cholesky(sharded_covariance(tmodel, _t(p0), x, mesh), mesh, block=BLOCK)
    p = _t(p0).clone().requires_grad_(True)
    v = sharded_negative_log_restricted_likelihood(tmodel, p, x, z, mesh, block=BLOCK, factor=L)
    v0 = sharded_negative_log_restricted_likelihood(tmodel, _t(p0), x, z, mesh, block=BLOCK)
    assert abs(float(v.detach()) - float(v0)) <= 1e-12 * abs(float(v0))
    with pytest.raises(ValueError, match="factor="):
        torch.autograd.grad(v, p)
    tmodel.covparam = p
    zpm, _zpv = sharded_predict(tmodel, xi, zi, xt, mesh, block=BLOCK, factor=L)
    with pytest.raises(ValueError, match="factor="):
        torch.autograd.grad(zpm.sum(), p)
