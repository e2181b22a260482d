# tests/test_torch_num.py
"""gpmp_tpu_torch.num (gnp) against gpmp_tpu.num on the same numpy inputs.

Tolerances: rel 1e-12 for the float64 linear algebra and distances
(both sides are exact f64 LAPACK-class algorithms on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp
import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def test_cholesky_solve_non_pd_gives_nan_not_exception():
    A = -np.eye(4)
    A[0, 1] = A[1, 0] = 0.5
    x, L = gnp.cholesky_solve(torch.as_tensor(A), torch.ones(4, dtype=torch.float64))
    assert torch.isnan(L).all() and torch.isnan(x).all()
    assert torch.isnan(gnp.logdet(torch.as_tensor(A)))
    # the JAX package's convention, for comparison
    xj, _ = jgnp.cholesky_solve(jax.numpy.asarray(A), jax.numpy.ones(4))
    assert np.isnan(np.asarray(xj)).all()


def test_cholesky_solve_matches_jax():
    A = _spd(7, 0)
    b = np.random.default_rng(1).normal(size=(7, 3))
    x, L = gnp.cholesky_solve(torch.as_tensor(A), torch.as_tensor(b))
    xj, Lj = jgnp.cholesky_solve(jax.numpy.asarray(A), jax.numpy.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(gnp.logdet(torch.as_tensor(A)).item(),
                               float(jgnp.logdet(jax.numpy.asarray(A))), rtol=1e-12)
    np.testing.assert_allclose(gnp.cholesky_inv(torch.as_tensor(A)).numpy(),
                               np.asarray(jgnp.cholesky_inv(jax.numpy.asarray(A))),
                               rtol=1e-12, atol=1e-15)


def test_safe_sqrt_zero_subgradient():
    d2 = torch.tensor([0.0, 4.0, 0.25], dtype=torch.float64, requires_grad=True)
    y = gnp._safe_sqrt(d2)
    np.testing.assert_array_equal(y.detach().numpy(), [0.0, 2.0, 0.5])
    (g,) = torch.autograd.grad(y.sum(), d2)
    np.testing.assert_array_equal(g.numpy(), [0.0, 0.25, 1.0])
    gj = jax.grad(lambda v: jax.numpy.sum(jgnp._safe_sqrt(v)))(
        jax.numpy.asarray([0.0, 4.0, 0.25]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))


@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("vector", [True, False], ids=["b_vector", "b_matrix"])
def test_solve_triangular_matches_jax(lower, trans, vector):
    L = np.linalg.cholesky(_spd(6, 2))
    A = L if lower else L.T
    rng = np.random.default_rng(3)
    b = rng.normal(size=(6,)) if vector else rng.normal(size=(6, 2))
    x = gnp.solve_triangular(torch.as_tensor(A), torch.as_tensor(b), lower=lower, trans=trans)
    xj = jgnp.solve_triangular(jax.numpy.asarray(A), jax.numpy.asarray(b), lower=lower,
                               trans=trans)
    assert x.shape == b.shape
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12)


def test_qr_solve_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(8, 8)) + 4 * np.eye(8)
    b = rng.normal(size=(8, 2))
    x = gnp.solve(torch.as_tensor(A), torch.as_tensor(b), assume_a="gen")
    xj = jgnp.solve(jax.numpy.asarray(A), jax.numpy.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12)
    np.testing.assert_allclose(A @ x.numpy(), b, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("blocked", [False, True])
def test_scaled_distance_and_cdist_match_jax(monkeypatch, blocked):
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(37, 4))
    x[5] = x[2]
    y = rng.uniform(size=(11, 4))
    loginvrho = rng.normal(size=4)
    ref_s = np.asarray(jgnp.scaled_distance(jax.numpy.asarray(loginvrho),
                                            jax.numpy.asarray(x), jax.numpy.asarray(y)))
    ref_c = np.asarray(jgnp.cdist(jax.numpy.asarray(x), jax.numpy.asarray(x)))
    if blocked:  # port side only: force the row-blocked branch (4-row blocks)
        monkeypatch.setattr(gnp, "_CDIST_BLOCK_BUDGET", 4 * 37 * 4)
    s = gnp.scaled_distance(torch.as_tensor(loginvrho), torch.as_tensor(x), torch.as_tensor(y))
    c = gnp.cdist(torch.as_tensor(x), torch.as_tensor(x))
    np.testing.assert_allclose(s.numpy(), ref_s, rtol=1e-12)
    np.testing.assert_allclose(c.numpy(), ref_c, rtol=1e-12, atol=0)
    assert c[5, 2] == 0.0 and c[2, 5] == 0.0


def test_scaled_distance_elementwise_matches_jax():
    rng = np.random.default_rng(6)
    x, y = rng.uniform(size=(9, 3)), rng.uniform(size=(9, 3))
    lr = rng.normal(size=3)
    xt = torch.as_tensor(x)
    d = gnp.scaled_distance_elementwise(torch.as_tensor(lr), xt, torch.as_tensor(y))
    dj = jgnp.scaled_distance_elementwise(jax.numpy.asarray(lr), jax.numpy.asarray(x),
                                          jax.numpy.asarray(y))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-12)
    z = gnp.scaled_distance_elementwise(torch.as_tensor(lr), xt, xt)
    assert z.shape == (9,) and not z.any()


def test_constructors_follow_dtype_and_device():
    t = torch.ones(3, dtype=torch.float64)
    assert gnp.asarray(t) is t  # identity kept: the covariance dispatch relies on it
    assert gnp.asarray(torch.ones(3, dtype=torch.float32)).dtype == torch.float64
    assert gnp.asarray(np.arange(3)).dtype == torch.int64
    one = gnp.asarray(2.5)
    assert one.shape == (1,) and one.dtype == torch.float64
    for made in (gnp.zeros((2, 3)), gnp.ones(4), gnp.eye(3), gnp.full((2,), 7.0)):
        assert made.dtype == torch.float64 and made.device.type == "cpu"
    arr = np.array([1.0, 2.0])
    copied = gnp.array(arr)
    arr[0] = 9.0
    assert copied[0] == 1.0
    np.testing.assert_allclose(gnp.gammaln(4.0).item(), np.log(6.0), rtol=1e-14)
    np.testing.assert_array_equal(gnp.to_np(gnp.concatenate([gnp.ones(1), gnp.zeros(1)])),
                                  [1.0, 0.0])
    assert gnp.to_scalar(gnp.sum(gnp.ones((2, 2)), axis=0)[0]) == 2.0
    assert gnp.max(gnp.asarray([1.0, 3.0])).item() == 3.0
    np.testing.assert_array_equal(gnp.maximum(gnp.asarray([-1.0, 2.0]), 0.0).numpy(),
                                  [0.0, 2.0])


def test_criterion_wrapper_caches_gradient_and_maps_nan_to_inf():
    calls = []

    def crit(p, x, z):
        calls.append(1)
        v = torch.sum((p - x) ** 2) + z.sum()
        return torch.where(p[0] > 5.0, torch.nan, v)

    w = gnp.DifferentiableSelectionCriterion(crit, np.array([1.0, 2.0]), np.array([0.5]))
    p = np.array([0.0, 0.0])
    assert w.evaluate_pre_grad(p) == pytest.approx(5.5)
    g = w.gradient(p)
    assert len(calls) == 1  # the gradient came from the cache
    np.testing.assert_allclose(g, [-2.0, -4.0])
    g2 = w.gradient(np.array([1.0, 0.0]))
    assert len(calls) == 2
    np.testing.assert_allclose(g2, [0.0, -4.0])
    assert w.evaluate(np.array([6.0, 0.0])) == np.inf
    np.testing.assert_array_equal(w.gradient(np.array([6.0, 0.0])), [0.0, 0.0])
    assert w.evaluate_no_grad(np.array([6.0, 0.0])) == np.inf
    assert w.evaluate_no_grad(p) == pytest.approx(5.5)


def test_is_linalg_exception():
    assert gnp._is_linalg_exception(RuntimeError("linalg.cholesky: not positive definite"))
    assert not gnp._is_linalg_exception(ValueError("shape mismatch"))
