# tests/test_torch_mixed.py
"""The mixed Cholesky engine of the port (gpmp_tpu_torch.ops.mixed) against
gpmp_tpu.ops.mixed, both in float64 on the CPU, on the same numpy inputs.

The port's kernels (K3, K4, K5, K7) run only on a CUDA card; here their
plain versions stand in, and chip_smoke.py holds the kernels to them on the
card.  Tolerances, each with its reason:

- K3 residual and norms: rel 1e-13 (f64, only the summation order differs);
- K4 factorization residual: max |diff| <= 2 f32 ulps of max |R| (both sides
  compute K - L L^T in f64, in another order, then round to f32);
- K5 triangular inverse: rel 1e-5 at cond 1e4 (f32 substitution in another
  order than XLA's triangular solve; error ~ eps32 cond(L));
- K7 trace sums: rel 1e-13 (f64 sums of products of f32 values);
- K7b LOO diagonal series: rel 1e-7 on the series branch (its correction is
  summed in f32, in another order than XLA's), 1e-13 on the two-level one;
- refined solve and logdet: the JAX package's own bars (tests/test_ops.py)
  against numpy, and port vs JAX within the same bars;
- gradients: port vs JAX's custom VJP and vs an f64 autograd oracle, rel
  1e-8 (series branch) / 1e-4 (two-level branch, O(eps cond) in the
  quadratic form), as tests/test_ops.py holds the JAX package; the LOO
  block's against numpy's exact gradient (1e-9 / 1e-6) and jax.grad (1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
from gpmp_tpu.ops import mixed as jmixed
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.core import linalg as tlinalg
from gpmp_tpu_torch.ops import mixed


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return Q @ np.diag(np.logspace(0, -np.log10(cond), n)) @ Q.T


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _l32(K):
    """The f32 factor of the preconditioner, as both packages build it."""
    L32, _ = mixed._f32_preconditioner(torch.as_tensor(K))
    return L32


# ---------------------------------------------------------------------------
# plain kernel versions vs their gpmp_tpu counterparts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 8])
def test_k3_residual_plain_matches_jax(k):
    n = 300
    rng = np.random.default_rng(k)
    K, X, B = _spd(n, 1e3, k), rng.normal(size=(n, k)), rng.normal(size=(n, k))
    R, norms = mixed.residual_plain(*map(torch.as_tensor, (K, X, B)))
    Rj = np.asarray(jax.jit(lambda K, X, B: B - jmixed._f64_matvec(K, X))(K, X, B))
    assert _rel(R.numpy(), Rj) <= 1e-13
    np.testing.assert_allclose(norms.numpy(), [np.sum(Rj**2), np.sum(B**2)], rtol=1e-13)
    # the dispatcher: CPU tensors take the plain version and count no launch
    before = mixed.K3_LAUNCHES
    R2, _ = mixed.residual(*map(torch.as_tensor, (K, X, B)))
    assert torch.equal(R2, R) and mixed.K3_LAUNCHES == before


@pytest.mark.parametrize("n", [300, 512])
def test_k4_factorization_residual_plain_matches_jax(n):
    K = _spd(n, 1e4, n)
    L32 = _l32(K)
    R = mixed.factorization_residual_plain(torch.as_tensor(K), L32).numpy()
    Rj = np.asarray(jax.jit(jmixed._factorization_residual_f32, static_argnums=2)(
        K, L32.double().numpy(), jmixed._residual_block(n)))
    assert R.dtype == np.float32 and np.array_equal(R, R.T)
    assert np.max(np.abs(R - Rj)) <= 2 * np.spacing(np.float32(np.max(np.abs(Rj))))


@pytest.mark.parametrize("n", [100, 256, 300])
def test_k5_triangular_inverse_matches_jax(n):
    L32 = _l32(_spd(n, 1e4, n + 1))
    M = mixed._block_tri_inv(L32, base=64).numpy()
    Mj = np.asarray(jax.jit(jmixed._block_tri_inv, static_argnums=1)(L32.numpy(), 64))
    assert M.dtype == np.float32 and np.all(np.triu(M, 1) == 0)
    assert _rel(M, Mj) <= 1e-5
    # the diagonal blocks alone, a ragged last block completed by the identity
    blocks = mixed.diag_block_inv_plain(L32, 64)
    ref = torch.linalg.solve_triangular(mixed._diag_blocks(L32, 64),
                                        torch.eye(64).expand(blocks.shape), upper=False)
    assert blocks.shape == (-(-n // 64), 64, 64)
    assert _rel(blocks.numpy(), ref.numpy()) <= 1e-5


def test_k7_trace_sums_plain_match_jax():
    """The traces of gpmp_tpu.ops.mixed._mp_solve_and_logdet_core (its nested
    ``_series``), written out with jnp as the JAX package computes them."""
    rng = np.random.default_rng(0)
    H = (1e-3 * rng.normal(size=(300, 300))).astype(np.float32)

    @jax.jit
    def jax_traces(H_):
        H2 = (H_ @ H_).astype(jnp.float64)
        H64 = H_.astype(jnp.float64)
        return jnp.stack([jnp.trace(H64), jnp.sum(H64 * H64), jnp.sum(H2 * H64),
                          jnp.sum(H2 * H2)]), H_ @ H_

    ref, H2 = jax_traces(H)
    Ht = torch.as_tensor(H)
    s12 = mixed.trace_sums_plain(Ht).numpy()
    s34 = mixed.series_sums_plain(Ht, torch.tensor(np.asarray(H2))).numpy()
    np.testing.assert_allclose(np.concatenate([s12, s34]), np.asarray(ref), rtol=1e-13)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cond,tol_x,tol_ld", [(1e2, 1e-11, 1e-10), (1e4, 1e-9, 1e-9),
                                               (1e6, 1e-4, 1e-6)])
def test_refined_solve_and_logdet_match_jax(cond, tol_x, tol_ld):
    n = 300
    K = _spd(n, cond, seed=2)
    B = np.random.default_rng(3).normal(size=(n, 3))
    X_ref = np.linalg.solve(K, B)
    ld_ref = np.linalg.slogdet(K)[1]
    Kt, Bt = torch.as_tensor(K), torch.as_tensor(B)
    X, _ = mixed.refined_cholesky_solve(Kt, Bt, n_refine=6)
    Xj = jax.jit(lambda K, B: jmixed.refined_cholesky_solve(K, B, n_refine=6)[0])(K, B)
    assert _rel(X.numpy(), X_ref) < tol_x and _rel(np.asarray(Xj), X_ref) < tol_x
    X2, ld = mixed.mp_solve_and_logdet(Kt, Bt)
    Xj2, ldj = jax.jit(jmixed.mp_solve_and_logdet)(K, B)
    assert abs(float(ld) - ld_ref) / abs(ld_ref) < tol_ld
    assert abs(float(ld) - float(ldj)) / abs(float(ldj)) < tol_ld
    assert _rel(X2.numpy(), np.asarray(Xj2)) < tol_x


@pytest.mark.parametrize("cond", [1e3, 1e6], ids=["series", "two_level"])
def test_analytic_backward_matches_jax_vjp_and_f64(cond):
    n = 200
    K0 = _spd(n, cond, seed=8)
    z = np.random.default_rng(9).normal(size=n)
    theta = np.array([0.07, -0.3])

    def nll_jax(th):
        K = jnp.asarray(K0) * jnp.exp(th[0]) + jnp.exp(th[1]) * jnp.eye(n) * 1e-9
        x, ld = jmixed.mp_solve_and_logdet(K, jnp.asarray(z))
        return 0.5 * (ld + jnp.asarray(z) @ x)

    def nll_torch(th, f64):
        eye = torch.eye(n, dtype=torch.float64)
        K = torch.as_tensor(K0) * torch.exp(th[0]) + torch.exp(th[1]) * eye * 1e-9
        zt = torch.as_tensor(z)
        if f64:
            x, C = tgnp.cholesky_solve(K, zt)
            ld = 2 * torch.sum(torch.log(torch.diagonal(C)))
        else:
            x, ld = mixed.mp_solve_and_logdet(K, zt)
        return 0.5 * (ld + zt @ x)

    def vg(f64):
        th = torch.as_tensor(theta).requires_grad_(True)
        v = nll_torch(th, f64)
        (g,) = torch.autograd.grad(v, th)
        return float(v.detach()), g.numpy()

    vj, gj = jax.jit(jax.value_and_grad(nll_jax))(jnp.asarray(theta))
    v_m, g_m = vg(False)
    v_f, g_f = vg(True)
    vtol, gtol = (1e-8, 1e-8) if cond < 1e4 else (1e-5, 1e-4)
    np.testing.assert_allclose(v_m, float(vj), rtol=vtol)
    np.testing.assert_allclose(g_m, np.asarray(gj), rtol=gtol)
    np.testing.assert_allclose(v_m, v_f, rtol=vtol)
    np.testing.assert_allclose(g_m, g_f, rtol=gtol)


def test_solve_cotangent_and_refined_solve_grad():
    """Bbar = S and Kbar = -S X^T: a parameter entering B and K."""
    n = 96
    K0 = _spd(n, 1e3, seed=10)
    z = np.random.default_rng(11).normal(size=n)

    def quad(th, solve):
        K = torch.as_tensor(K0) * torch.exp(th[0])
        b = torch.as_tensor(z) * th[1]
        return b @ solve(K, b)

    def grad(solve):
        th = torch.tensor([0.2, 1.3], dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(quad(th, solve), th)
        return g.numpy()

    g_ref = grad(lambda K, b: torch.linalg.solve(K, b))
    np.testing.assert_allclose(grad(lambda K, b: mixed.mp_solve_and_logdet(K, b)[0]),
                               g_ref, rtol=1e-9)
    np.testing.assert_allclose(grad(mixed.refined_solve), g_ref, rtol=1e-9)


def test_non_pd_gives_nan_and_inf_with_zero_gradient():
    n = 200
    x, ld = mixed.mp_solve_and_logdet(-torch.eye(n, dtype=torch.float64),
                                      torch.ones(n, dtype=torch.float64))
    assert torch.isnan(ld) and torch.isnan(x).all()
    _, d = mixed.mp_solve_and_inv_diag(-torch.eye(n, dtype=torch.float64),
                                       torch.ones(n, dtype=torch.float64))
    assert torch.isnan(d).all()

    # through the criterion: +inf with a zero gradient, on the mixed engine
    rng = np.random.default_rng(0)
    xi, zi = rng.uniform(size=(n, 2)), rng.normal(size=n)

    def kernel(x, y, c, pairwise=False):
        K = tgp.kernel.maternp_covariance(x, y, 2, c, pairwise)
        if (y is x or y is None) and not pairwise:
            K = K - 2.0 * K[0, 0] * tgnp.eye(x.shape[0])
        return K

    model = tgp.Model(lambda x, m: tgnp.ones((x.shape[0], 1)), kernel)
    config.set_chol_engine("mixed")
    try:
        crit = tgp.kernel.make_selection_criterion_with_gradient(
            model, tgp.kernel.negative_log_restricted_likelihood, xi, zi)
        assert crit[1](np.array([0.0, 1.0, 1.0])) == np.inf
        np.testing.assert_array_equal(crit[3](np.array([0.0, 1.0, 1.0])), np.zeros(3))
    finally:
        config.set_chol_engine("auto")


def test_mixed_engine_gate_below_192():
    config.set_chol_engine("mixed")
    try:
        assert tlinalg.chol_engine(191) == "f64"
        assert tlinalg.chol_engine(192) == "mixed"
        assert tlinalg.chol_engine() == "mixed"
        K = torch.as_tensor(_spd(191, 1e3, 1))
        before = mixed.K4_LAUNCHES
        X, ld = tlinalg.solve_and_logdet(K, torch.ones(191, dtype=torch.float64))
        Xf, Cf = tgnp.cholesky_solve(K, torch.ones(191, dtype=torch.float64))
        assert torch.equal(X, Xf)  # the f64 engine itself, not a close result
        assert mixed.K4_LAUNCHES == before
    finally:
        config.set_chol_engine("auto")
    assert tlinalg.chol_engine(10000) == "f64"


def test_k7b_loo_diag_plain_matches_jax():
    """The column sums of gpmp_tpu.ops.mixed.mp_solve_and_inv_diag, series
    (f32 correction) and two-level (f64) branches, written out with jnp."""
    rng = np.random.default_rng(12)
    n = 250
    M32 = np.tril(rng.normal(size=(n, n))).astype(np.float32)
    B32 = (1e-3 * rng.normal(size=(n, n))).astype(np.float32)
    G, W = rng.normal(size=(n, n)), rng.normal(size=(n, n))
    ref_s = jax.jit(lambda M, B: jnp.sum(M.astype(jnp.float64) ** 2, axis=0)
                    - jnp.sum(M * B, axis=0).astype(jnp.float64))(M32, B32)
    ref_p = jax.jit(lambda G, W: jnp.sum(G * W, axis=0))(G, W)
    d_s = mixed.loo_diag_series(torch.as_tensor(M32), torch.as_tensor(B32), torch.float64)
    d_p = mixed.loo_diag_pairs(torch.as_tensor(G), torch.as_tensor(W))
    assert d_s.dtype == d_p.dtype == torch.float64 and mixed.K7B_LAUNCHES == 0
    assert _rel(d_s.numpy(), np.asarray(ref_s)) <= 1e-7  # f32 sums in another order
    assert _rel(d_p.numpy(), np.asarray(ref_p)) <= 1e-13


def _loo_loss_inputs(n, cond, seed):
    """K(theta) = e^t0 K0 + e^t1 I, B = t2 b; loss = w'X + v'diag(K^{-1})."""
    rng = np.random.default_rng(seed)
    K0 = _spd(n, cond, seed)
    b, w, v = rng.normal(size=n), rng.normal(size=n), rng.normal(size=n)
    return K0, b, w, v, np.array([0.1, np.log(1.0 / cond), 1.3])


def _loo_loss_port(theta, K0, b, w, v):
    th = torch.tensor(theta, requires_grad=True)
    K = torch.exp(th[0]) * torch.as_tensor(K0) + torch.exp(th[1]) * torch.eye(K0.shape[0],
                                                                             dtype=torch.float64)
    X, d = mixed.mp_solve_and_inv_diag(K, th[2] * torch.as_tensor(b))
    (g,) = torch.autograd.grad(torch.as_tensor(w) @ X + torch.as_tensor(v) @ d, th)
    return g.numpy()


@pytest.mark.parametrize("cond,rtol", [(1e2, 1e-9), (1e6, 1e-6)], ids=["series", "two_level"])
def test_loo_block_gradient_matches_exact_f64(cond, rtol):
    """The analytic backward of mp_solve_and_inv_diag against the exact
    gradient from numpy's f64 inverse: Kbar = -K^{-1} diag(v) K^{-1} - S X^T,
    Bbar = S = K^{-1} w.  Envelope per component: the accuracy of the
    refined solve behind K^{-1} and S, rel 1e-9 at cond 1e2 (measured 1e-14)
    and 1e-6 at cond 1e6, where its stagnation exit leaves ~cond * 1e-13
    (measured 2.1e-7; the logdet backward's envelope there is 1e-4)."""
    n = 200
    K0, b, w, v, theta = _loo_loss_inputs(n, cond, seed=13)
    K = np.exp(theta[0]) * K0 + np.exp(theta[1]) * np.eye(n)
    Ki = np.linalg.inv(K)
    S, X = Ki @ w, Ki @ (theta[2] * b)
    Kbar = -Ki @ np.diag(v) @ Ki - np.outer(S, X)
    exact = np.array([np.sum(Kbar * np.exp(theta[0]) * K0), np.exp(theta[1]) * np.trace(Kbar),
                      S @ b])
    np.testing.assert_allclose(_loo_loss_port(theta, K0, b, w, v), exact, rtol=rtol)


def test_loo_block_gradient_matches_jax():
    """Against jax.grad of gpmp_tpu's mp_solve_and_inv_diag (jitted), which
    differentiates its unrolled sweeps and f32 series: rel 1e-10 per
    component (measured 3e-12 at n = 200, cond 1e2..1e5)."""
    n = 200
    K0, b, w, v, theta = _loo_loss_inputs(n, 1e3, seed=14)

    def loss(th):
        K = jnp.exp(th[0]) * jnp.asarray(K0) + jnp.exp(th[1]) * jnp.eye(n)
        X, d = jmixed.mp_solve_and_inv_diag(K, th[2] * jnp.asarray(b))
        return jnp.asarray(w) @ X + jnp.asarray(v) @ d

    gj = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(theta)))
    np.testing.assert_allclose(_loo_loss_port(theta, K0, b, w, v), gj, rtol=1e-10)
