# tests/test_torch_distance.py
"""K1d (ops.distance) and K1m (ops.gram maternp) plain versions against the
JAX package, values and gradients, on the same numpy inputs.

The kernels run only on a CUDA card; chip_smoke.py holds them to these plain
versions there.  Here the dispatchers (gnp.scaled_distance,
gnp.scaled_distance_elementwise, kernel.maternp_kernel) take the plain
forward and the plain pullback inside their autograd Functions, which is
the arithmetic the kernels implement.  Tolerances: values rel 1e-12
(float64; only the summation order over d can differ), gradients rel 1e-11
against jax.grad of the same composition (the explicit pullback sums in
float64 in another order than JAX's autodiff), float32 rel 1e-5 against the
float64 JAX result.  Inputs hold duplicated rows and coincident x/y points
(D = 0: the zero subgradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu.kernel as jkernel
import gpmp_tpu.num as jgnp
import gpmp_tpu_torch.kernel as tkernel
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import distance, gram


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
    return x, y, rng.uniform(-0.5, 1.5, size=d), rng.normal(size=(n, m))


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _jax_vg(fn, l0, dbar, jit=True):
    """(value, grad of <dbar, fn(l)>) of a JAX function of l, jitted unless
    asked otherwise."""
    dbar = jnp.asarray(dbar)
    l0 = jnp.asarray(l0)
    grad = jax.grad(lambda l: jnp.sum(dbar * fn(l)))
    if jit:
        fn, grad = jax.jit(fn), jax.jit(grad)
    return np.asarray(fn(l0)), np.asarray(grad(l0))


def _torch_vg(fn, l0, dbar, dtype=torch.float64):
    lt = torch.tensor(l0, dtype=dtype, requires_grad=True)
    out = fn(lt)
    (g,) = torch.autograd.grad(torch.sum(torch.as_tensor(dbar, dtype=dtype) * out), lt)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("kind", ["cross", "same", "elementwise"])
@pytest.mark.parametrize("d", [1, 6])
def test_scaled_distance_values_and_gradient_match_jax(d, kind):
    n, m = 29, (29 if kind != "cross" else 17)
    x, y, l0, dbar = _inputs(n, m, d, seed=d + len(kind))
    if kind == "elementwise":
        dbar = dbar[:, 0]
        jfn = lambda l: jgnp.scaled_distance_elementwise(l, jnp.asarray(x), jnp.asarray(y))
        tfn = lambda l, dt=torch.float64: tgnp.scaled_distance_elementwise(
            l, torch.as_tensor(x, dtype=dt), torch.as_tensor(y, dtype=dt))
    else:
        yy = x if kind == "same" else y
        jfn = lambda l: jgnp.scaled_distance(l, jnp.asarray(x), jnp.asarray(yy))
        tfn = lambda l, dt=torch.float64: tgnp.scaled_distance(
            l, torch.as_tensor(x, dtype=dt), torch.as_tensor(yy, dtype=dt))
    D_ref, g_ref = _jax_vg(jfn, l0, dbar)
    D, g = _torch_vg(tfn, l0, dbar)
    # coincident points give exact zeros (rows 0, 1 of x are rows 3, 4 of x
    # and rows 0, 1 of y)
    zero = [(0, 0), (1, 1)] if kind == "elementwise" else [(3, 0), (4, 1), (0, 0)]
    assert all(D[i] == 0.0 if kind == "elementwise" else D[i, j] == 0.0 for i, j in zero)
    assert _rel(D, D_ref) <= 1e-12
    assert _rel(g, g_ref) <= 1e-11
    D32, g32 = _torch_vg(lambda l: tfn(l, torch.float32), l0, dbar, torch.float32)
    assert D32.dtype == np.float32 and g32.dtype == np.float32
    assert _rel(D32, D_ref) <= 1e-5 and _rel(g32, g_ref) <= 1e-5
    # CPU tensors take the plain versions and count no launch
    assert distance.K1D_LAUNCHES == 0 and distance.K1D_PULLBACK_LAUNCHES == 0


@pytest.mark.parametrize("p", [0, 2, 3])
@pytest.mark.parametrize("d", [1, 6])
def test_user_matern_gram_values_and_gradient_match_jax(d, p):
    """k_p(scaled_distance(l, x, x)) through K1d and K1m's plain versions,
    with a gradient for l and for the distance (K1m's backward), as a user
    covariance composes them."""
    x, _, l0, dbar = _inputs(31, 31, d, seed=40 + d + p)

    def jfn(l):
        return jkernel.maternp_kernel(p, jgnp.scaled_distance(l, jnp.asarray(x), jnp.asarray(x)))

    def tfn(l):
        xt = torch.as_tensor(x)
        return tkernel.maternp_kernel(p, tgnp.scaled_distance(l, xt, xt))

    # jitted on the CPU, XLA contracts e^l x_i - e^l x_i into an FMA that
    # leaves ~1e-16 on the diagonal of D; where k_p'(0) != 0 (p = 0) its
    # gradient then differs from the eager one, which the port matches
    K_ref, g_ref = _jax_vg(jfn, l0, dbar, jit=p > 0)
    K, g = _torch_vg(tfn, l0, dbar)
    assert _rel(K, K_ref) <= 1e-12
    assert _rel(g, g_ref) <= 1e-11
    assert gram.K1M_LAUNCHES == 0 and gram.K1M_BACKWARD_LAUNCHES == 0


@pytest.mark.parametrize("p", [0, 1, 2, 3, 5])
def test_maternp_backward_plain_is_the_derivative(p):
    """maternp_kernel_backward_plain against JAX's derivative of its
    maternp_kernel, with h = 0 and h = inf (0 there) included."""
    h = np.array([0.0, 1e-9, 0.3, 1.7, 6.0, np.inf])
    kbar = np.random.default_rng(p).normal(size=h.shape)
    dk = jax.jit(jax.vmap(jax.grad(lambda v: jkernel.maternp_kernel(p, v))))(
        jnp.asarray(h[:-1]))
    got = gram.maternp_kernel_backward_plain(p, torch.as_tensor(h), torch.as_tensor(kbar))
    assert _rel(got.numpy()[:-1], kbar[:-1] * np.asarray(dk)) <= 1e-13
    assert got[-1] == 0.0
    np.testing.assert_array_equal(gram.maternp_kernel(p, torch.as_tensor(h)).numpy(),
                                  gram.maternp_kernel_plain(p, torch.as_tensor(h)).numpy())


def test_xy_gradients_off_the_main_path():
    """The gradient for x and y comes from the plain composition, on demand."""
    x, y, l0, dbar = _inputs(9, 7, 3, seed=3)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    D = tgnp.scaled_distance(torch.as_tensor(l0), xt, yt)
    gx, gy = torch.autograd.grad(torch.sum(torch.as_tensor(dbar[:, :7]) * D), (xt, yt))
    fn = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.asarray(dbar[:, :7])
                                               * jgnp.scaled_distance(jnp.asarray(l0), a, b)),
                          (0, 1)))
    gxj, gyj = fn(jnp.asarray(x), jnp.asarray(y))
    assert _rel(gx.numpy(), np.asarray(gxj)) <= 1e-12
    assert _rel(gy.numpy(), np.asarray(gyj)) <= 1e-12


def test_plain_versions_call_no_dispatcher(monkeypatch):
    """The plain gram (the kernels' oracle) composes the plain distance and
    Matérn functions, never the dispatchers."""
    def boom(*a, **k):
        raise AssertionError("dispatcher reached from a plain version")

    monkeypatch.setattr(distance, "scaled_distance", boom)
    monkeypatch.setattr(gram, "maternp_kernel", boom)
    monkeypatch.setattr(tgnp, "scaled_distance", boom)
    x, _, l0, _ = _inputs(8, 8, 2, seed=1)
    xt = torch.as_tensor(x)
    theta = torch.as_tensor(np.concatenate([[0.2], l0]))
    K = gram.matern_gram_plain(xt, xt, 2, theta, same=True)
    assert K.shape == (8, 8)


def test_distance_kernel_wrappers_refuse_cpu_tensors():
    x = torch.rand(5, 2, dtype=torch.float64)
    l = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        distance.scaled_distance_cuda(l, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        distance.scaled_distance_pullback_cuda(torch.ones(5, 5, dtype=torch.float64), l, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        distance.scaled_distance_elementwise_cuda(l, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram.maternp_kernel_cuda(2, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram.maternp_kernel_backward_cuda(2, x, x)
    with pytest.raises(ValueError, match="one device"):
        tgnp.scaled_distance(l.to("meta"), x, x)


def test_isotropic_loginvrho_broadcasts():
    x, y, _, dbar = _inputs(7, 5, 3, seed=9)
    lt = torch.tensor([0.4], dtype=torch.float64, requires_grad=True)
    D = tgnp.scaled_distance(lt, torch.as_tensor(x), torch.as_tensor(y))
    (g,) = torch.autograd.grad(torch.sum(torch.as_tensor(dbar[:, :5]) * D), lt)
    Dj, gj = _jax_vg(lambda l: jgnp.scaled_distance(l, jnp.asarray(x), jnp.asarray(y)),
                     np.array([0.4]), dbar[:, :5])
    assert _rel(D.detach().numpy(), Dj) <= 1e-12 and _rel(g.numpy(), gj) <= 1e-12
