# tests/test_torch_second_order.py
"""Second derivatives and point gradients through the port's custom autograd
Functions, on the CPU, against gpmp_tpu on the same numpy inputs.

- The REML Hessian in covparam through the built-in Matern covariance (K1/K2,
  ops/gram.py ``MaternGram``) and through a user covariance composing
  ``gnp.scaled_distance`` (K1d) with ``maternp_kernel`` (K1m), against
  ``jax.hessian``: rel 1e-8 of max |H| (the same f64 algorithm on both
  sides; the bar leaves room for the two Cholesky libraries' orders).
- The predicted mean's gradient in xt through the built-in covariance,
  against ``jax.grad``: rel 1e-8 likewise.
- Every other custom Function has a first-order rule only: its gradient is
  finite and nonzero, and asking for a differentiable one (create_graph, a
  Hessian) raises (none returns zeros, None or NaN in silence).
"""

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
from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import mixed as omixed
from gpmp_tpu_torch.parallel import chol as pchol, likelihood as plik, make_mesh
from gpmp_tpu_torch.parallel import mixed as pmixed, streamed as pstreamed

N, D = 30, 2
CP = np.array([0.0, 1.0, 0.5])


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _models(builtin):
    out = []
    for gp, gnp in ((jgp, jgnp), (tgp, tgnp)):
        if builtin:
            def k(x, y, c, pairwise=False, gp=gp):
                return gp.kernel.maternp_covariance(x, y, 2, c, pairwise)
        else:
            def k(x, y, c, pairwise=False, gp=gp, gnp=gnp):
                y = x if y is None else y
                if pairwise:
                    Dm = gnp.scaled_distance_elementwise(c[1:], x, y)
                else:
                    Dm = gnp.scaled_distance(c[1:], x, y)
                return gnp.exp(c[0]) * gp.kernel.maternp_kernel(2, Dm)
        out.append(gp.Model(lambda x, p, gnp=gnp: gnp.ones((x.shape[0], 1)), k))
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xi = rng.uniform(size=(N, D))
    zi = np.sin(3.0 * xi[:, 0]) + xi[:, 1]
    xt = rng.uniform(size=(7, D))
    return xi, zi, xt


@pytest.mark.parametrize("route", ["builtin", "user"])
def test_reml_hessian_matches_jax(data, route):
    xi, zi, _ = data
    jm, tm = _models(route == "builtin")
    Hj = np.asarray(jax.jit(jax.hessian(
        lambda c: jm.negative_log_restricted_likelihood(c, jnp.asarray(xi), jnp.asarray(zi))
    ))(jnp.asarray(CP)))
    xt_, zt_ = torch.as_tensor(xi), torch.as_tensor(zi)
    Ht = torch.autograd.functional.hessian(
        lambda c: tm.negative_log_restricted_likelihood(c, xt_, zt_), torch.as_tensor(CP)).numpy()
    assert np.all(np.isfinite(Ht)) and np.max(np.abs(Ht)) > 0
    assert _rel(Ht, Hj) <= 1e-8
    assert _rel(Ht, Ht.T) <= 1e-10


def test_predict_mean_gradient_in_xt_matches_jax(data):
    xi, zi, xt = data
    jm, tm = _models(True)
    jm.covparam, tm.covparam = jnp.asarray(CP), torch.as_tensor(CP)
    gj = np.asarray(jax.grad(
        lambda t: jnp.sum(jm.predict(jnp.asarray(xi), jnp.asarray(zi), t,
                                     convert_out=False)[0] ** 2))(jnp.asarray(xt)))
    xtt = torch.as_tensor(xt).requires_grad_(True)
    zpm, _ = tm.predict(torch.as_tensor(xi), torch.as_tensor(zi), xtt, convert_out=False)
    (gt,) = torch.autograd.grad(torch.sum(zpm ** 2), xtt)
    assert np.max(np.abs(gj)) > 0
    assert _rel(gt.numpy(), gj) <= 1e-8


# ---------------------------------------------------------------------------
# the first-order Functions: a gradient, and a loud error on the second
# derivative
# ---------------------------------------------------------------------------
NF = 256


def _spd(n=NF):
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return torch.as_tensor(np.exp(-4.0 * d2)), torch.as_tensor(rng.normal(size=(n, 2))), x


def _K(p, A):
    return torch.exp(p[0]) * A + torch.exp(p[1]) * torch.eye(A.shape[0], dtype=A.dtype)


def _noisy_model():
    def kernel(x, y, c, pairwise=False):
        s2, noise, l = tgnp.exp(c[0]), tgnp.exp(c[1]), c[2:]
        if y is x or y is None:
            Dm = tgnp.scaled_distance(l, x, x)
            return s2 * tgp.kernel.maternp_kernel(2, Dm) + noise * tgnp.eye(x.shape[0])
        return s2 * tgp.kernel.maternp_kernel(2, tgnp.scaled_distance(l, x, y))

    return tgp.Model(lambda x, p: tgnp.ones((x.shape[0], 1)), kernel)


def _case(name):
    """(scalar function of p, p) through the named Function."""
    A, B, x = _spd()
    mesh = make_mesh(1, axis_name="shard")
    if name == "mp_solve_and_logdet":
        def f(p):
            X, ld = omixed.mp_solve_and_logdet(_K(p, A), B)
            return X.sum() + ld
    elif name == "refined_solve":
        def f(p):
            return omixed.refined_solve(_K(p, A), B).sum()
    elif name == "mp_solve_and_inv_diag":
        def f(p):
            X, dg = omixed.mp_solve_and_inv_diag(_K(p, A), B)
            return X.sum() + dg.sum()
    elif name in ("blocked_solve_lower", "blocked_solve_upper_t", "sharded_cholesky"):
        def f(p):
            L = pchol.sharded_cholesky(_K(p, A), mesh, block=64)
            if name == "sharded_cholesky":
                return (L * L).sum()
            fn = getattr(pchol, name)
            return fn(L.detach(), B * torch.exp(p[0]), block=64).sum()
    elif name == "sharded_mp_solve_and_logdet":
        def f(p):
            X, ld = pmixed.sharded_mp_solve_and_logdet(_K(p, A), B, mesh, block=64)
            return X.sum() + ld
    elif name in ("cov_f32_backward", "streamed_mp_solve_and_logdet"):
        model = _noisy_model()
        xi = torch.as_tensor(x)
        if name == "cov_f32_backward":
            def f(p):
                return plik._CovF32Backward.apply(p, model, xi, xi.to(torch.float32),
                                                  None).sum()
        else:
            def f(p):
                X, ld = pstreamed.streamed_mp_solve_and_logdet(model, p, xi, B, mode="ff",
                                                               robust=True)
                return X.sum() + ld
        return f, torch.tensor([0.0, np.log(1e-2), 0.3, 0.2], dtype=torch.float64)
    return f, torch.tensor([0.1, np.log(1e-2)], dtype=torch.float64)


@pytest.mark.parametrize("name", [
    "mp_solve_and_logdet", "refined_solve", "mp_solve_and_inv_diag",
    "blocked_solve_lower", "blocked_solve_upper_t", "sharded_cholesky",
    "cov_f32_backward", "sharded_mp_solve_and_logdet", "streamed_mp_solve_and_logdet",
])
def test_first_order_functions_raise_on_second_derivative(name):
    f, p0 = _case(name)
    p = p0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(p), p)
    assert torch.all(torch.isfinite(g)) and torch.any(g != 0)
    with pytest.raises(RuntimeError, match="second derivatives are not implemented"):
        torch.autograd.grad(f(p), p, create_graph=True)
    with pytest.raises(RuntimeError, match="second derivatives are not implemented"):
        torch.autograd.functional.hessian(f, p0.clone())
