# tests/test_torch_gram.py
"""Plain versions of K1/K2 (ops.gram) against the JAX package.

matern_gram_plain is held to gpmp_tpu.kernel.maternp_covariance and
matern_gram_pullback_plain to jax.grad of <Kbar, K(theta)>, on the same
numpy inputs, with duplicated rows (h = 0 off the diagonal) and coincident
x/y points.  Tolerances: float64 value rel 1e-12 (elementwise), gradient
rel 1e-10 (max |diff| / max |grad|); float32 value and gradient rel 1e-5
against the float64 JAX result.  The kernels themselves run only on a CUDA
card; chip_smoke.py holds them to these plain versions there.
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu.kernel as jkernel
import gpmp_tpu.num as jnp_gnp  # noqa: F401  (enables x64 in the JAX package)
from gpmp_tpu_torch.ops import gram
from gpmp_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _inputs(n, m, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[3:5] = x[0:2]  # duplicated rows
    y = rng.uniform(size=(m, d))
    y[:2] = x[:2]  # coincident x/y points
    theta = np.concatenate([[0.4], rng.uniform(-0.5, 1.5, size=d)])
    kbar = rng.normal(size=(n, n))
    return x, y, theta, kbar


def _jax_gram(x, y, p, theta, same):
    xj = jax.numpy.asarray(x)
    yj = xj if same else jax.numpy.asarray(y)
    return jkernel.maternp_covariance(xj, yj, p, jax.numpy.asarray(theta))


def _jax_grad(x, y, p, theta, kbar, same):
    xj = jax.numpy.asarray(x)
    yj = xj if same else jax.numpy.asarray(y)
    kb = jax.numpy.asarray(kbar)
    return np.asarray(jax.grad(
        lambda th: jax.numpy.sum(kb * jkernel.maternp_covariance(xj, yj, p, th))
    )(jax.numpy.asarray(theta)))


def _relmax(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("same", [True, False], ids=["ii", "it"])
@pytest.mark.parametrize("p", [0, 1, 2, 3])
@pytest.mark.parametrize("d", [1, 6])
def test_gram_and_pullback_match_jax(d, p, same):
    n, m = 23, 17
    x, y, theta, kbar = _inputs(n, m, d, seed=10 * d + p)
    if not same:
        kbar = kbar[:, :m]
    K_ref = np.asarray(_jax_gram(x, y, p, theta, same))
    g_ref = _jax_grad(x, y, p, theta, kbar, same)

    xt = torch.as_tensor(x)
    yt = xt if same else torch.as_tensor(y)
    th = torch.as_tensor(theta)
    K = gram.matern_gram_plain(xt, yt, p, th, same).numpy()
    np.testing.assert_allclose(K, K_ref, rtol=1e-12, atol=0)
    g = gram.matern_gram_pullback_plain(torch.as_tensor(kbar), xt, yt, p, th, same)
    assert g.dtype == torch.float64 and g.shape == (d + 1,)
    assert _relmax(g.numpy(), g_ref) <= 1e-10

    # the autograd Function on CPU tensors: same numbers, no launch counted
    k1, k2 = gram.K1_LAUNCHES, gram.K2_LAUNCHES
    th_req = th.clone().requires_grad_(True)
    K_fn = gram.matern_gram(xt, yt, p, th_req, same)
    (g_fn,) = torch.autograd.grad(torch.sum(K_fn * torch.as_tensor(kbar)), th_req)
    np.testing.assert_array_equal(K_fn.detach().numpy(), K)
    assert _relmax(g_fn.numpy(), g_ref) <= 1e-10
    assert (gram.K1_LAUNCHES, gram.K2_LAUNCHES) == (k1, k2)

    # float32: same formulas in single precision
    x32 = torch.as_tensor(x, dtype=torch.float32)
    y32 = x32 if same else torch.as_tensor(y, dtype=torch.float32)
    th32 = torch.as_tensor(theta, dtype=torch.float32)
    K32 = gram.matern_gram_plain(x32, y32, p, th32, same)
    assert K32.dtype == torch.float32
    assert _relmax(K32.double().numpy(), K_ref) <= 1e-5
    g32 = gram.matern_gram_pullback_plain(
        torch.as_tensor(kbar, dtype=torch.float32), x32, y32, p, th32, same)
    assert _relmax(g32.numpy(), g_ref) <= 1e-5


@pytest.mark.parametrize("p", [0, 2])
def test_pullback_blocked_rows_match_unblocked(monkeypatch, p):
    import gpmp_tpu_torch.num as tgnp

    x, _, theta, kbar = _inputs(30, 30, 3, seed=7)
    args = (torch.as_tensor(kbar), torch.as_tensor(x), torch.as_tensor(x), p,
            torch.as_tensor(theta), True)
    g_full = gram.matern_gram_pullback_plain(*args)
    monkeypatch.setattr(tgnp, "_CDIST_BLOCK_BUDGET", 7 * 30 * 3)  # 7-row blocks
    g_blocked = gram.matern_gram_pullback_plain(*args)
    assert _relmax(g_blocked.numpy(), g_full.numpy()) <= 1e-13


def test_maternp_kernel_limits_and_derivative():
    h = torch.tensor([0.0, 0.3, 1.7, float("inf")], dtype=torch.float64)
    for p in range(6):
        k = gram.maternp_kernel(p, h).numpy()
        assert abs(k[0] - 1.0) <= 1e-14 and k[-1] == 0.0
        np.testing.assert_allclose(
            k[:3], np.asarray(jkernel.maternp_kernel(p, jax.numpy.asarray(h.numpy()[:3]))),
            rtol=1e-13)
        # k_p'(h) = c e^{-ch} sum_k b_k (2ch)^k against a central difference
        c = 2.0 * np.sqrt(p + 0.5)
        b = gram._maternp_dpoly_coeffs(p)
        hh = torch.tensor([0.3, 1.7], dtype=torch.float64)
        dk = (c * torch.exp(-c * hh) * gram._horner(b, 2.0 * c * hh)).numpy()
        eps = 1e-6
        fd = (gram.maternp_kernel(p, hh + eps) - gram.maternp_kernel(p, hh - eps)).numpy() / (2 * eps)
        np.testing.assert_allclose(dk, fd, rtol=1e-7)


def test_matern_gram_rejects_x_grad_and_mixed_devices():
    """x and y that require grad get their cotangents (the plain
    composition's: it once raised NotImplementedError); mixed devices still
    raise."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(4, 2, dtype=torch.float64, generator=g, requires_grad=True)
    y = torch.rand(3, 2, dtype=torch.float64, generator=g, requires_grad=True)
    th = torch.tensor([0.2, 0.4, -0.3], dtype=torch.float64)
    w = torch.rand(4, 3, dtype=torch.float64, generator=g)
    for yy, same, ww in ((x, True, w[:, :1] * w[:, :1].T), (y, False, w)):
        got = torch.autograd.grad(torch.sum(ww * gram.matern_gram(x, yy, 2, th, same)), (x, yy))
        want = torch.autograd.grad(torch.sum(ww * gram.matern_gram_plain(x, yy, 2, th, same)),
                                   (x, yy))
        for a, b in zip(got, want):
            assert torch.any(b != 0)
            torch.testing.assert_close(a, b, rtol=1e-13, atol=0)
    with pytest.raises(ValueError, match="one device"):
        gram.matern_gram(x.detach(), x.detach(), 2, th.to("meta"), True)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise: no fallback to the plain version."""
    x = torch.rand(5, 2, dtype=torch.float64)
    th = torch.zeros(3, dtype=torch.float64)
    k1, k2 = gram.K1_LAUNCHES, gram.K2_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram.matern_gram_cuda(x, x, 2, th, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram.matern_gram_pullback_cuda(torch.ones(5, 5, dtype=torch.float64), x, x, 2, th, True)
    assert (gram.K1_LAUNCHES, gram.K2_LAUNCHES) == (k1, k2)


def test_covariance_dispatch_matches_jax():
    """maternp_covariance: ii/tt (nugget) on identity, it otherwise, pairwise branches."""
    import gpmp_tpu_torch.kernel as tkernel

    x, y, theta, _ = _inputs(9, 9, 3, seed=3)
    xt, yt, th = torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(theta)
    xj, yj, thj = (jax.numpy.asarray(a) for a in (x, y, theta))
    for p in (1, 3):
        for (a, b), (aj, bj) in (((xt, xt), (xj, xj)), ((xt, None), (xj, None)),
                                 ((xt, yt), (xj, yj))):
            for pairwise in (False, True):
                K = tkernel.maternp_covariance(a, b, p, th, pairwise)
                Kj = jkernel.maternp_covariance(aj, bj, p, thj, pairwise)
                assert K.shape == Kj.shape
                np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-12, atol=0)
