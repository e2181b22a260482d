# tests/test_torch_numpy_operands.py
"""NumPy operands through the port, as gpmp_tpu takes them.

gpmp_tpu takes a NumPy array (or a Python sequence) wherever it takes an
array, because ``jnp`` converts it; the port converts at the same public
boundary (``gnp._tensor``): the Model methods that take covparam,
meanparam, xi, zi or xt, the ``core.likelihood`` entry points, the
``gnp`` ops, and the covariance functions of ``kernel``.  Each call here gets NumPy operands on both sides, on the CPU,
in f64, gpmp_tpu's criteria under ``jax.jit``, and the port's result is
held bitwise to the same call on tensors (the conversion changes nothing
else) and to gpmp_tpu at 1e-12 relative (max |diff| / max |value|).  At
n = 200 the parity workload's K has cond(K) ~3.5e5, and the two packages'
LAPACK Cholesky factors of the same K differ by ~cond(K) eps64 (gpmp_tpu
jitted and unjitted differ by 8e-13 on its NLL; the port by up to 1.9e-11
on the kriging weights): there the bar is 1e-10, tests/test_torch_core.py's
for the same calls on tensors.  Tensors are taken as they are: operands on
two torch devices still raise.
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.num as jgnp
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.core import likelihood as tlik
from gpmp_tpu.core import likelihood as jlik

P_SMOOTH = 2


def _tol(n):
    """1e-12; 1e-10 at the parity workload's n = 200 (cond(K) ~3.5e5)."""
    return 1e-12 if n <= 40 else 1e-10


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _relmax(a, b):
    a = np.asarray(tgnp.to_np(a), dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# the workload of tests/test_reference_parity.py:40-80 (its make_data, the
# Matern p=2 kernel, zero and constant means), at n <= 200
def _make_data(n, d=2, seed=1234):
    rng = np.random.default_rng(seed + n)
    xi = rng.uniform(size=(n, d))
    zi = np.sin(4.0 * xi[:, 0]) + 0.7 * xi[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    xt = rng.uniform(size=(16, d))
    covparam = np.array([np.log(0.8)] + [np.log(1.0 / 0.15)] * d)
    return xi, zi, xt, covparam


def _models(meantype, covparam=None, meanparam=None):
    def jkernel(x, y, c, pairwise=False):
        return jgp.kernel.maternp_covariance(x, y, P_SMOOTH, c, pairwise)

    def tkernel(x, y, c, pairwise=False):
        return tgp.kernel.maternp_covariance(x, y, P_SMOOTH, c, pairwise)

    def mean(gnp):
        def m(x, param):
            if meantype == "parameterized":
                return param * gnp.ones((x.shape[0], 1))
            return gnp.ones((x.shape[0], 1))
        return None if meantype == "zero" else m

    return (jgp.Model(mean(jgnp), jkernel, meanparam, covparam, meantype=meantype),
            tgp.Model(mean(tgnp), tkernel, meanparam, covparam, meantype=meantype))


@pytest.mark.parametrize("n", [6, 40, 200])
def test_reference_parity_workload(n):
    """tests/test_reference_parity.py's calls, NumPy operands throughout."""
    tol = _tol(n)
    xi, zi, xt, cp = _make_data(n)
    jm0, tm0 = _models("zero", cp)
    jv = jax.jit(jm0.negative_log_likelihood_zero_mean)(cp, xi, zi)
    tv = tm0.negative_log_likelihood_zero_mean(cp, xi, zi)
    assert _relmax(tv, jv) <= tol
    for a, b in zip(tm0.predict(xi, zi, xt), jm0.predict(xi, zi, xt)):
        assert _relmax(a, b) <= tol
    jm1, tm1 = _models("linear_predictor", cp)
    jv = jax.jit(jm1.negative_log_restricted_likelihood)(cp, xi, zi)
    tv = tm1.negative_log_restricted_likelihood(cp, xi, zi)
    assert _relmax(tv, jv) <= tol
    # the parity test's own call: the module function on the model
    jv = jax.jit(lambda c, x, z: jlik.negative_log_restricted_likelihood(jm1, c, x, z))(
        cp, xi, zi)
    assert _relmax(tlik.negative_log_restricted_likelihood(tm1, cp, xi, zi), jv) <= tol
    for a, b in zip(tm1.predict(xi, zi, xt), jm1.predict(xi, zi, xt)):
        assert _relmax(a, b) <= tol
    for a, b in zip(tm1.loo(xi, zi, convert_out=True), jm1.loo(xi, zi, convert_out=True)):
        assert _relmax(a, b) <= tol


def _model_calls(name, xi, zi, xt, cp, mp):
    """(the call on a model, the model's mean type) of each Model method
    that takes covparam, meanparam, xi, zi or xt."""
    return {
        "negative_log_likelihood_zero_mean": (
            lambda m: m.negative_log_likelihood_zero_mean(cp, xi, zi), "zero"),
        "negative_log_likelihood": (
            lambda m: m.negative_log_likelihood(mp, cp, xi, zi), "parameterized"),
        "negative_log_restricted_likelihood": (
            lambda m: m.negative_log_restricted_likelihood(cp, xi, zi), "linear_predictor"),
        "negative_log_restricted_likelihood contrast": (
            lambda m: m.negative_log_restricted_likelihood(cp, xi, zi, impl="contrast"),
            "linear_predictor"),
        "norm_k_sqrd_with_zero_mean": (
            lambda m: m.norm_k_sqrd_with_zero_mean(xi, zi, cp), "zero"),
        "norm_k_sqrd": (lambda m: m.norm_k_sqrd(xi, zi, cp), "linear_predictor"),
        "k_inverses": (lambda m: m.k_inverses(xi, zi, cp), "linear_predictor"),
        "kriging_predictor_with_zero_mean": (
            lambda m: m.kriging_predictor_with_zero_mean(xi, xt), "zero"),
        "kriging_predictor": (lambda m: m.kriging_predictor(xi, xt), "linear_predictor"),
    }[name]


@pytest.mark.parametrize("n", [40, 200])
@pytest.mark.parametrize("name", [
    "negative_log_likelihood_zero_mean", "negative_log_likelihood",
    "negative_log_restricted_likelihood", "negative_log_restricted_likelihood contrast",
    "norm_k_sqrd_with_zero_mean", "norm_k_sqrd", "k_inverses",
    "kriging_predictor_with_zero_mean", "kriging_predictor"])
def test_model_methods_take_numpy(name, n):
    xi, zi, xt, cp = _make_data(n)
    mp = np.array([0.3])
    call, meantype = _model_calls(name, xi, zi, xt, cp, mp)
    jm, tm = _models(meantype, cp, mp if meantype == "parameterized" else None)
    jout = jax.jit(lambda: call(jm))()
    tout = call(tm)
    # the same call on tensors: bitwise the same
    on_tensors, _ = _model_calls(name, *map(torch.as_tensor, (xi, zi, xt, cp, mp)))
    tref = on_tensors(tm)
    jout, tout, tref = (o if isinstance(o, tuple) else (o,) for o in (jout, tout, tref))
    assert len(tout) == len(jout) == len(tref)
    for a, b, c in zip(tout, jout, tref):
        assert isinstance(a, torch.Tensor) and torch.equal(a, c)
        assert _relmax(a, b) <= _tol(n)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


_RNG = np.random.default_rng(20261017)
_X, _Y = _RNG.uniform(size=(30, 3)), _RNG.uniform(size=(30, 3))
_A, _B = _spd(12, 1), _RNG.normal(size=(12, 2))
_L = np.tril(_RNG.uniform(0.5, 1.5, size=(12, 12)))
_RHO = np.array([0.3, -0.2, 0.1])
_M = _RNG.normal(size=(4, 5))
# (gnp op, NumPy operands; a Python scalar where the op takes one)
GNP_CASES = {
    "cholesky": ("cholesky", (_A,)),
    "logdet": ("logdet", (_A,)),
    "cholesky_inv": ("cholesky_inv", (_A,)),
    "cholesky_solve": ("cholesky_solve", (_A, _B)),
    "solve": ("solve", (_A, _B)),
    "solve_triangular": ("solve_triangular", (_L, _B[:, 0], True)),
    "qr": ("qr", (_M.T,)),
    "cdist": ("cdist", (_X, _Y)),
    "scaled_distance": ("scaled_distance", (_RHO, _X, _Y)),
    "scaled_distance same": ("scaled_distance", (_RHO, _X, _X)),
    "scaled_distance isotropic": ("scaled_distance", (0.25, _X, _Y)),
    "scaled_distance_elementwise": ("scaled_distance_elementwise", (_RHO, _X, _Y)),
    "scaled_distance_elementwise same": ("scaled_distance_elementwise", (_RHO, _X, _X)),
    "sum": ("sum", (_M,)),
    "sum axis": ("sum", (_M, 1)),
    "max": ("max", (_M,)),
    "max axis": ("max", (_M, 0)),
    "min": ("min", (_M,)),
    "min axis": ("min", (_M, 1)),
    "any": ("any", (_M > 1.0,)),
    "diag vector": ("diag", (_M[0],)),
    "diag matrix": ("diag", (_A,)),
    "reshape": ("reshape", (_M, (5, 4))),
    "concatenate": ("concatenate", ([_M, _M[:2]],)),
    "concatenate axis": ("concatenate", ([_M, _M[:, :1]], 1)),
    "stack": ("stack", ([_M[0], _M[1], _M[3]],)),
}


@pytest.mark.parametrize("case", sorted(GNP_CASES))
def test_gnp_ops_take_numpy(case):
    name, args = GNP_CASES[case]
    tout = getattr(tgnp, name)(*args)
    jout = getattr(jgnp, name)(*args)
    tout = tout if isinstance(tout, tuple) else (tout,)
    jout = jout if isinstance(jout, tuple) else (jout,)
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        b = np.asarray(b)
        if b.dtype == bool:
            assert a.dtype == torch.bool and np.array_equal(a.numpy(), b)
        else:
            assert a.dtype == torch.float64
            assert _relmax(a, b) <= 1e-12


_PARAM = np.concatenate([[0.3], _RHO])
_H = np.abs(_M)
KERNEL_CASES = {
    "maternp_covariance x is x": ("maternp_covariance", (_X, _X, P_SMOOTH, _PARAM)),
    "maternp_covariance y None": ("maternp_covariance", (_X, None, P_SMOOTH, _PARAM)),
    "maternp_covariance cross": ("maternp_covariance", (_X, _Y, P_SMOOTH, _PARAM)),
    "maternp_covariance pairwise": ("maternp_covariance", (_X, _X, P_SMOOTH, _PARAM, True)),
    "maternp_covariance pairwise cross": ("maternp_covariance",
                                          (_X, _X[::-1].copy(), P_SMOOTH, _PARAM, True)),
    "maternp_covariance_ii_or_tt": ("maternp_covariance_ii_or_tt", (_X, 3, _PARAM)),
    "maternp_covariance_it": ("maternp_covariance_it", (_X, _Y, 0, _PARAM)),
    "maternp_kernel": ("maternp_kernel", (5, _H)),
    "matern32_kernel": ("matern32_kernel", (_H,)),
    "exponential_kernel": ("exponential_kernel", (_H,)),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_functions_take_numpy(case):
    """The covariance functions of ``kernel`` take NumPy operands as
    gpmp_tpu's do (they raised AttributeError or TypeError before)."""
    name, args = KERNEL_CASES[case]
    tout = getattr(tgp.kernel, name)(*args)
    jout = np.asarray(getattr(jgp.kernel, name)(*args))
    assert isinstance(tout, torch.Tensor) and tout.dtype == torch.float64
    assert _relmax(tout, jout) <= 1e-12


def test_tensors_are_taken_as_they_are():
    """A tensor operand is never converted or moved; tensors on two torch
    devices still raise in the kernels' dispatch."""
    x = torch.as_tensor(_X)
    assert tgnp._tensor(x) is x
    assert tgnp.scaled_distance(torch.as_tensor(_RHO), x, x).shape == (30, 30)
    meta = torch.empty(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="one device"):
        tgnp.scaled_distance(meta, x, x)
    with pytest.raises(ValueError, match="one device"):
        tgp.kernel.maternp_covariance(x, x, P_SMOOTH, torch.empty(4, dtype=torch.float64,
                                                                  device="meta"))
