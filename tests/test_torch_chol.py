# tests/test_torch_chol.py
"""The blocked Cholesky with refined panels of the port
(gpmp_tpu_torch.parallel.chol, the plain versions of its kernels K8r/K8t in
gpmp_tpu_torch.ops.refine and K9u/K9m in ops.chol) against gpmp_tpu.ops.refine
and gpmp_tpu.parallel.chol on a one-device mesh, both in float64 on the CPU,
on the same numpy inputs.

The kernels run only on a CUDA card; here their plain versions run, and
chip_smoke.py holds the kernels to them on the card.  Tolerances, each with
its reason:

- K8r: E = A - L L^T for an f32 factor L (|E| ~ eps32 |A|): max |diff| <=
  8 b eps64 max|A| (f64 sums of b products in another order); the guard's
  sums rel 1e-6 (sum E^2, E itself differs ~1e-9) and 1e-13 (sum A^2);
- K8t, K9m phi and sym: the Newton step, the update and Murray's passes
  rel 1e-13 (f64 products in another order), phi and sym bitwise (the same
  f64 operations);
- K9u: max |diff| <= 8 b eps64 of (|S| + |T||T|^T) entrywise (f64 sums of b
  products in another order);
- the blocked factor, its solves and Murray's backward: rel 1e-12, both
  sides the same exact f64 algorithm on a well-conditioned K;
- the refined panel factor and its solve on panels of cond(A) up to 1e5:
  rel 1e-14 sqrt(cond(A)) (f64 roundoff in another order, amplified by
  cond(L) = sqrt(cond(A)); 1e-12 at cond(A) 1e4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
from gpmp_tpu.ops import refine as jrefine
from gpmp_tpu.parallel import chol as jchol
from gpmp_tpu.parallel import make_mesh as jmake_mesh

from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import chol as ops, refine
from gpmp_tpu_torch.parallel import chol as pchol

EPS64 = float(np.finfo(np.float64).eps)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = Q @ np.diag(np.logspace(0, -np.log10(cond), n)) @ Q.T
    return 0.5 * (A + A.T)


def _matern_K(n, seed=0):
    """A noisy Matern-5/2 covariance on uniform points in [0, 1]^3."""
    x = np.random.default_rng(seed).uniform(size=(n, 3))
    D = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) / 0.3
    return (1 + np.sqrt(5) * D + 5 / 3 * D ** 2) * np.exp(-np.sqrt(5) * D) + 1e-2 * np.eye(n)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(1, axis_name="shard")


# ---------------------------------------------------------------------------
# plain kernel versions vs the JAX expressions they replace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cond", [1e3, 1e6])
def test_k8r_plain_matches_jax(cond):
    b = 128
    A = _spd(b, cond, 1)
    L = np.linalg.cholesky(A.astype(np.float32)).astype(np.float64)
    E, sums = refine.refine_residual_plain(_t(A), _t(L))
    Ej = np.asarray(jax.jit(lambda a, l: a - l @ l.T)(A, L))
    assert torch.equal(E, E.T)
    assert np.max(np.abs(E.numpy() - Ej)) <= 8 * b * EPS64 * np.max(np.abs(A))
    assert abs(float(sums[0]) - np.sum(Ej * Ej)) <= 1e-6 * np.sum(Ej * Ej)
    assert abs(float(sums[1]) - np.sum(A * A)) <= 1e-13 * np.sum(A * A)


def test_k8t_plain_matches_jax():
    b = 128
    A = _spd(b, 1e3, 2)
    L = np.linalg.cholesky(A)
    M32 = np.linalg.inv(L.astype(np.float32)).astype(np.float64)
    M32 = np.tril(M32)
    # the Newton step, two K8t products, against M (2I - L M)
    M = refine.newton_tri_inv(_t(L), _t(M32), steps=1)
    Mj = np.asarray(jax.jit(lambda l, m: jrefine.newton_tri_inv(l, m, steps=1))(L, M32))
    assert _rel(M.numpy(), Mj) <= 1e-13
    assert np.all(np.triu(M.numpy(), 1) == 0.0)
    # the Ogita-Aishima update L + L Phi(X) on a full X
    X = np.random.default_rng(3).normal(size=(b, b)) * 1e-8
    U = refine.tri_product(_t(L), _t(X), beta=1.0, alpha=1.0, phi=True)
    Uj = np.asarray(jax.jit(lambda l, x: l + l @ jrefine._phi(x))(L, X))
    assert _rel(U.numpy(), Uj) <= 1e-13
    # the dispatcher takes the plain version on CPU tensors, no launch counted
    before = refine.K8T_LAUNCHES
    assert torch.equal(refine.tri_product(_t(L), _t(M32)),
                       refine.tri_product_plain(_t(L), _t(M32)))
    assert refine.K8T_LAUNCHES == before


def test_k9u_plain_matches_jax():
    n, b, c0 = 640, 128, 128
    A = _matern_K(n, 4)
    off = c0 + b
    out = ops.trailing_update_plain(_t(A).clone(), c0, b).numpy()
    T = A[off:, c0:off]
    ref = np.asarray(jax.jit(lambda s, t: s - t @ t.T)(A[off:, off:], T))
    scale = np.abs(A[off:, off:]) + np.abs(T) @ np.abs(T).T
    assert np.all(np.abs(out[off:, off:] - ref) <= 8 * b * EPS64 * scale)
    assert np.array_equal(out[off:, off:], out[off:, off:].T)
    assert np.array_equal(out[:, :off], A[:, :off]) and np.array_equal(out[:off], A[:off])
    with pytest.raises(ValueError, match="trailing"):
        ops.trailing_update_plain(_t(A), n - b, b)


def test_k9m_plain_matches_jax():
    P = np.random.default_rng(5).normal(size=(300, 300))
    phi = ops.murray_phi_plain(_t(P).clone()).numpy()
    assert np.array_equal(phi, np.asarray(jax.jit(jrefine._phi)(P)))
    sym = ops.symmetrize_plain(_t(P).clone()).numpy()
    assert np.array_equal(sym, np.asarray(jax.jit(lambda s: 0.5 * (s + s.T))(P)))
    assert np.array_equal(sym, sym.T)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor a *_cuda wrapper raises; it never falls back."""
    A = _t(_spd(64, 10.0, 6))
    for call in (lambda: refine.refine_residual_cuda(A, A), lambda: refine.tri_product_cuda(A, A),
                 lambda: ops.trailing_update_cuda(A.clone(), 0, 32),
                 lambda: ops.murray_phi_cuda(A.clone()), lambda: ops.symmetrize_cuda(A.clone())):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the refined panel factor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cond", [1e4, 1e5])
def test_refined_cholesky_matches_jax(cond):
    b = 128
    A = _spd(b, cond, 7)
    tol = 1e-14 * np.sqrt(cond)
    L, M = refine.refined_cholesky(_t(A), with_inverse=True)
    Lj, Mj = jax.jit(lambda a: jrefine.refined_cholesky(a, with_inverse=True))(A)
    assert _rel(L.numpy(), np.asarray(Lj)) <= tol
    assert _rel(M.numpy(), np.asarray(Mj)) <= tol
    assert _rel(L.numpy(), np.linalg.cholesky(A)) <= tol
    B = np.random.default_rng(8).normal(size=(300, b))
    T = refine.refined_solve_lower(L, M, _t(B))
    Tj = jax.jit(jrefine.refined_solve_lower)(Lj, Mj, B)
    assert _rel(T.numpy(), np.asarray(Tj)) <= tol


@pytest.mark.parametrize("case", ["not PD", "guard"])
def test_refined_cholesky_nan_guard(case):
    """A non-PD panel, or a guard no factor can meet, gives an all-NaN factor
    and inverse, as in the JAX package."""
    A = _spd(64, 1e2, 9)
    rtol2 = 1e-16
    if case == "not PD":
        A = A - 2.0 * np.eye(64)
    else:
        rtol2 = 0.0
    L, M = refine.refined_cholesky(_t(A), with_inverse=True, rtol2=rtol2)
    Lj, Mj = jrefine.refined_cholesky(jnp.asarray(A), with_inverse=True, rtol2=rtol2)
    for a in (L.numpy(), M.numpy(), np.asarray(Lj), np.asarray(Mj)):
        assert np.all(np.isnan(a))


# ---------------------------------------------------------------------------
# the blocked factor, its solves and their backwards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,block", [(512, 128), (640, 128), (640, 160), (512, 160)])
def test_blocked_factor_and_solves_match_jax(jmesh, n, block):
    K = _matern_K(n, n)
    B = np.random.default_rng(10).normal(size=(n, 3))
    if n % block:
        with pytest.raises(ValueError, match="divisible"):
            pchol.sharded_cholesky(_t(K), None, block=block)
        with pytest.raises(ValueError, match="divisible"):
            jchol.sharded_cholesky(jnp.asarray(K), jmesh, block=block)
        return
    Kt = _t(K)
    L = pchol.sharded_cholesky(Kt, None, block=block)
    assert np.array_equal(Kt.numpy(), K)  # the public factor leaves K alone
    Lj = jax.jit(lambda k: jchol.sharded_cholesky(k, jmesh, block=block))(K)
    assert _rel(L.numpy(), np.asarray(Lj)) <= 1e-12
    assert np.all(np.triu(L.numpy(), 1) == 0.0)
    y = pchol.blocked_solve_lower(L, _t(B), block=block)
    x = pchol.blocked_solve_upper_t(L, y, block=block)
    yj = jax.jit(lambda l, b: jchol.blocked_solve_lower(l, b, block=block))(Lj, B)
    xj = jax.jit(lambda l, b: jchol.blocked_solve_upper_t(l, b, block=block))(Lj, yj)
    assert _rel(y.numpy(), np.asarray(yj)) <= 1e-12
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-12
    assert _rel(x.numpy(), np.linalg.solve(K, B)) <= 1e-10
    # the in-place factor of predict and LOO: the same L in K's own buffer
    K2 = _t(K).clone()
    L2 = pchol._factor_in_place(K2, None, block)
    assert L2.data_ptr() == K2.data_ptr() and torch.equal(L2, L)


def test_murray_and_solve_backwards_match_jax(jmesh):
    """The gradient of a scalar of (L, y, x) through the factor and both
    solves: Murray's backward (K9m's passes) and the solves' adjoints
    against jax.grad of the JAX package's custom VJPs."""
    n, block = 384, 128
    K = _matern_K(n, 11)
    rng = np.random.default_rng(12)
    B, W = rng.normal(size=(n, 2)), rng.normal(size=(n, n))

    def f_jax(k, b):
        L = jchol.sharded_cholesky(k, jmesh, block=block)
        y = jchol.blocked_solve_lower(L, b, block=block)
        x = jchol.blocked_solve_upper_t(L, y, block=block)
        return jnp.sum(jnp.tril(W) * L) + jnp.sum(x * b) + jnp.sum(jnp.log(jnp.diag(L)))

    gk_j, gb_j = jax.jit(jax.grad(f_jax, argnums=(0, 1)))(K, B)
    Kt, Bt = _t(K).requires_grad_(True), _t(B).requires_grad_(True)
    L = pchol.sharded_cholesky(Kt, None, block=block)
    x = pchol.blocked_solve_upper_t(L, pchol.blocked_solve_lower(L, Bt, block=block),
                                    block=block)
    f = torch.sum(torch.tril(_t(W)) * L) + torch.sum(x * Bt) + torch.sum(torch.log(torch.diag(L)))
    gk, gb = torch.autograd.grad(f, (Kt, Bt))
    assert _rel(gk.numpy(), np.asarray(gk_j)) <= 1e-12
    assert _rel(gb.numpy(), np.asarray(gb_j)) <= 1e-12
    assert torch.equal(gk, gk.T)


def test_factor_refuses_gradient():
    """A precomputed factor= serves values; a gradient through it with
    respect to the guarded K raises, as the JAX package's barrier does."""
    n, block = 256, 128
    K = _t(_matern_K(n, 13))
    L = pchol.sharded_cholesky(K, None, block=block)
    B = _t(np.random.default_rng(14).normal(size=(n, 2)))
    Kg = K.clone().requires_grad_(True)
    X, ld = pchol.sharded_solve_and_logdet(Kg, B, None, block=block, factor=L)
    X0, ld0 = pchol.sharded_solve_and_logdet(K, B, None, block=block)
    assert torch.equal(X.detach(), X0) and torch.equal(ld, ld0)
    with pytest.raises(ValueError, match="factor="):
        torch.autograd.grad(X.sum(), Kg)
