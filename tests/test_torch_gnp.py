# tests/test_torch_gnp.py
"""The rest of ``gnp``: its surface, its ops, its distributions and its
criterion wrappers, against gpmp_tpu.num on the CPU in f64.

- The surface: every public name of gpmp_tpu.num is in the port but the
  stated exclusions (the JAX modules and names, the PRNG key, the typing
  aliases, and the modules the JAX package imports).
- The ops take NumPy operands, as the JAX package's do, and match it at
  1e-12 relative (max |diff| / max |value|; integers and booleans
  exactly).  The general-matrix linear algebra is LU in the port and QR
  in the JAX package: well-conditioned inputs, and slogdet's sign on a
  matrix with a negative determinant; logdet keeps NaN off the SPD cone.
- ``normal``/``multivariate_normal`` and the Normal classes: densities and
  cdfs at 1e-12; draws (torch.Generator against JAX keys) by moments.
- ``evaluate_batch``: bitwise the rows evaluated one by one, and 1e-12 of
  gpmp_tpu's vmapped rows; NaN maps to +inf.  The criteria are taken where
  cond(K) is ~1e4 or less: at cond(K) ~1e6 (n = 40, rho ~0.4) the two
  packages' f64 values already part by ~6e-12, cond(K) eps.
- ``BatchDifferentiableSelectionCriterion`` and
  ``SecondOrderDifferentiableFunction`` against gpmp_tpu at 1e-10 (f64
  engine), and the second's retry on the mixed engine, logged.
"""

import logging
import types

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.kernel  # noqa: F401
import gpmp_tpu.num as jgnp
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config

TOL = 1e-12


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _np(x):
    return np.asarray(tgnp.to_np(x) if isinstance(x, torch.Tensor) else x)


def _assert_close(a, b, tol=TOL):
    """a (port) against b (gpmp_tpu): the same structure and shapes, exact
    for integers and booleans, relative max error <= tol for floats (NaN and
    inf in the same places)."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for u, v in zip(a, b):
            _assert_close(u, v, tol)
        return
    if isinstance(a, torch.Tensor):
        assert a.device.type == "cpu"
    a, b = _np(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not np.issubdtype(b.dtype, np.floating):
        assert np.array_equal(a, b), (a, b)
        return
    bad_a, bad_b = ~np.isfinite(a), ~np.isfinite(b)
    assert np.array_equal(bad_a, bad_b) and np.array_equal(a[bad_a], b[bad_b],
                                                           equal_nan=True)
    if (~bad_b).any():
        err = np.max(np.abs(a[~bad_b] - b[~bad_b]))
        assert err <= tol * max(np.max(np.abs(b[~bad_b])), 1e-300), err


# ----------------------------------------------------------------------------
# The surface
# ----------------------------------------------------------------------------
EXCLUDED = {
    "jax", "jnp", "lax", "next_key",  # JAX itself and its PRNG key
    "Any", "ArrayLike", "CriterionCallable", "Iterable", "LoaderLike", "Optional",
    "Scalar", "Tuple", "Union",  # typing aliases
    "functools", "os",  # modules the JAX package imports
}


def test_gnp_surface_is_the_reference_but_the_exclusions():
    missing = {n for n in dir(jgnp) if not n.startswith("_") and not hasattr(tgnp, n)}
    assert missing == EXCLUDED
    for attr in ("pdf", "logpdf", "cdf", "logcdf", "ppf", "rvs"):
        assert callable(getattr(tgnp.normal, attr))
    for attr in ("rvs", "logpdf", "cdf"):
        assert callable(getattr(tgnp.multivariate_normal, attr))
    for cls in ("DifferentiableSelectionCriterion", "BatchDifferentiableSelectionCriterion",
                "SecondOrderDifferentiableFunction", "Normal", "MultivariateNormal"):
        assert isinstance(getattr(tgnp, cls), type)
    assert not any(isinstance(getattr(tgnp, n), types.ModuleType) and n in ("jax", "jnp")
                   for n in dir(tgnp))


# ----------------------------------------------------------------------------
# The ops
# ----------------------------------------------------------------------------
def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


_R = np.random.default_rng(20261018)
_V = _R.normal(size=12)
_M = _R.normal(size=(4, 5))
_S = _spd(6, 2)
_G = _R.normal(size=(6, 6)) + 3.0 * np.eye(6)
_GNEG = _G.copy()
_GNEG[0] = -_GNEG[0]
_I = np.array([3, 1, 3, 2, 7, 1])
_POS = np.abs(_V) + 0.1


def _c(name, *args, **kwargs):
    return (name, args, kwargs)


OPS = {
    "where": _c("where", _M > 0, _M, 0.0),
    "where condition alone": _c("where", _M > 0),
    "clip": _c("clip", _M, -0.5, 0.5),
    "isfinite": _c("isfinite", np.array([1.0, np.inf, -np.inf, np.nan])),
    "isnan": _c("isnan", np.array([1.0, np.inf, np.nan])),
    "isinf": _c("isinf", np.array([1.0, -np.inf, np.nan])),
    "isclose": _c("isclose", _M, _M + 1e-9 * np.sign(_M)),
    "allclose": _c("allclose", _M, _M + 1e-3),
    "array_equal": _c("array_equal", _M, _M.copy()),
    "nan_to_num": _c("nan_to_num", np.array([1.0, np.nan, np.inf, -np.inf])),
    "linspace": _c("linspace", 0.0, 2.0, 7),
    "linspace no endpoint": _c("linspace", -1.0, 1.0, 8, endpoint=False),
    "logspace": _c("logspace", -2.0, 1.0, 6),
    "meshgrid": _c("meshgrid", _V[:3], _V[3:7]),
    "hstack": _c("hstack", (_M, _M[:, :2])),
    "vstack": _c("vstack", (_M, _M[:1])),
    "tile": _c("tile", _M, (2, 1)),
    "take": _c("take", _M, np.array([0, 7, 3])),
    "take axis": _c("take", _M, np.array([4, 0]), axis=1),
    "split": _c("split", np.arange(12.0), 3),
    "split points": _c("split", np.arange(12.0), [2, 5]),
    "squeeze": _c("squeeze", _M[None, :, :1]),
    "expand_dims": _c("expand_dims", _M, 1),
    "atleast_2d": _c("atleast_2d", _V),
    "transpose": _c("transpose", _M[None], 0, 2),
    "sort": _c("sort", _M),
    "sort axis 0": _c("sort", _M, axis=0),
    "argsort": _c("argsort", _V),
    "unique": _c("unique", _I, return_index=True, return_inverse=True, return_counts=True),
    "argmin": _c("argmin", _M),
    "argmax axis": _c("argmax", _M, axis=1),
    "cumsum": _c("cumsum", _M),
    "cumsum axis": _c("cumsum", _M, axis=1),
    "diff": _c("diff", _V),
    "convolve": _c("convolve", _V[:5], _V[5:8]),
    "convolve same": _c("convolve", _V[:5], _V[5:8], mode="same"),
    "convolve valid": _c("convolve", _V[:5], _V[5:8], mode="valid"),
    "mean": _c("mean", _M),
    "mean axis": _c("mean", _M, axis=0),
    "std": _c("std", _M),
    "std axis ddof": _c("std", _M, axis=1, ddof=1),
    "var": _c("var", _M),
    "cov": _c("cov", _M),
    "cov rowvar": _c("cov", _M.T, rowvar=False),
    "quantile": _c("quantile", _V, 0.3),
    "quantile axis": _c("quantile", _M, np.array([0.1, 0.9]), axis=1),
    "percentile": _c("percentile", _V, 75.0),
    "norm": _c("norm", _V),
    "norm ord 1": _c("norm", _V, 1),
    "norm frobenius": _c("norm", _M),
    "norm axis": _c("norm", _M, axis=1),
    "norm spectral": _c("norm", _M, 2),
    "trace": _c("trace", _S),
    "inner": _c("inner", _V[:4], _V[4:8]),
    "outer": _c("outer", _V[:3], _V[3:5]),
    "prod": _c("prod", _V[:5]),
    "log10": _c("log10", _POS),
    "log1p": _c("log1p", _POS),
    "sin": _c("sin", _V),
    "cos": _c("cos", _V),
    "tan": _c("tan", _V),
    "tanh": _c("tanh", _V),
    "abs": _c("abs", _V),
    "floor": _c("floor", 3 * _V),
    "ceil": _c("ceil", 3 * _V),
    "minimum": _c("minimum", _V, 0.2),
    "logical_and": _c("logical_and", _V > 0, _V < 1),
    "logical_or": _c("logical_or", _V > 1, _V < -1),
    "logical_not": _c("logical_not", _V > 0),
    "eye k": _c("eye", 4, 5, 1),
    "sum dtype initial where": _c("sum", _M, initial=2.0, where=_M > 0),
    "sum axis keepdims": _c("sum", _M, axis=1, keepdims=True),
    "max initial where": _c("max", _M, initial=-10.0, where=_M < 1.0),
    "min axis keepdims": _c("min", _M, axis=0, keepdims=True),
    "any axis keepdims": _c("any", _M > 1.0, axis=0, keepdims=True),
    "all axis": _c("all", _M > -2.0, axis=1),
    "slogdet": _c("slogdet", _S),
    "slogdet negative determinant": _c("slogdet", _GNEG),
    "det negative determinant": _c("det", _GNEG),
    "inv": _c("inv", _G),
    "cond": _c("cond", _G),
    "logdet not positive definite": _c("logdet", -_S),
    "svd values": _c("svd", _G, compute_uv=False),
    "compute_gammaln": _c("compute_gammaln", 3),
    "inftobigf": _c("inftobigf", np.array([1.0, np.inf, -np.inf])),
    "asint": _c("asint", np.array([1.7, -2.2])),
    "asdouble": _c("asdouble", _I),
    "copy": _c("copy", _M),
    "zeros_like": _c("zeros_like", _M),
    "ones_like": _c("ones_like", _I),
    "full_like": _c("full_like", _M, 2.5),
    "custom_sqrt": _c("custom_sqrt", np.array([0.0, 4.0, 2.0])),
    "safe_inf": _c("safe_inf"),
    "safe_neginf": _c("safe_neginf"),
    "isscalar 0-d": _c("isscalar", np.array(1.0)),
    "isarray": _c("isarray", _M),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_gnp_op_matches_jax(case):
    name, args, kwargs = OPS[case]
    out = getattr(tgnp, name)(*args, **kwargs)
    ref = getattr(jgnp, name)(*args, **kwargs)
    if isinstance(ref, bool):
        assert out is ref
        return
    _assert_close(out, ref)


def test_gnp_factorizations_match_jax():
    """eigh, svd and cho_factor/cho_solve, up to the signs of the vectors."""
    w, V = tgnp.eigh(_S)
    jw, jV = jgnp.eigh(_S)
    _assert_close(w, jw)
    _assert_close(V @ torch.diag(w) @ V.T, np.asarray(jV) @ np.diag(jw) @ np.asarray(jV).T)
    U, s, Vh = tgnp.svd(_G)
    jU, js, jVh = jgnp.svd(_G)
    _assert_close(s, js)
    _assert_close((U * s) @ Vh, (np.asarray(jU) * np.asarray(js)) @ np.asarray(jVh))
    B = _M[:, :1].repeat(2, 1)[:4]
    for lower in (False, True):
        c = tgnp.cho_factor(_S[:4, :4], lower=lower)
        jc = jgnp.cho_factor(_S[:4, :4], lower=lower)
        _assert_close(tgnp.cho_solve(c, B), jgnp.cho_solve(jc, B))


def test_gnp_linspace_split_errors_and_eye_default():
    with pytest.raises(ValueError):
        tgnp.split(np.arange(7.0), 3)
    _assert_close(tgnp.eye(3), np.eye(3))
    y, step = tgnp.linspace(0.0, 1.0, 5, retstep=True)
    jy, jstep = jgnp.linspace(0.0, 1.0, 5, retstep=True)
    _assert_close(y, jy)
    assert float(step) == float(jstep)


# ----------------------------------------------------------------------------
# Distributions
# ----------------------------------------------------------------------------
_X = np.linspace(-6.0, 6.0, 41)
_C2 = np.array([[1.0, 0.6], [0.6, 2.0]])
_PTS = np.array([[0.3, -0.2], [1.0, 0.5], [-1.5, 2.0]])


@pytest.mark.parametrize("fn", ["pdf", "logpdf", "cdf", "logcdf"])
def test_normal_matches_jax(fn):
    ref = jax.jit(lambda: (getattr(jgnp.normal, fn)(_X, loc=0.5, scale=1.7),
                           getattr(jgnp.normal, fn)(_X)))()
    _assert_close(getattr(tgnp.normal, fn)(_X, 0.5, 1.7), ref[0])
    _assert_close(getattr(tgnp.normal, fn)(_X), ref[1])


def test_normal_ppf_and_classes_match_jax():
    q = np.linspace(0.01, 0.99, 9)

    def jax_side():
        j = jgnp.Normal(0.5, 2.0)
        jm = jgnp.MultivariateNormal(np.array([0.1, -0.2]), _C2)
        return (jgnp.normal.ppf(q, loc=1.0, scale=2.0), j.log_prob(_X), j.cdf(_X), j.icdf(q),
                j.variance, jm.log_prob(_PTS))

    ref = jax.jit(jax_side)()
    t = tgnp.Normal(0.5, 2.0)
    tm = tgnp.MultivariateNormal(np.array([0.1, -0.2]), _C2)
    _assert_close((tgnp.normal.ppf(q, 1.0, 2.0), t.log_prob(_X), t.cdf(_X), t.icdf(q),
                   t.variance, tm.log_prob(_PTS)), ref)


def test_multivariate_normal_matches_jax():
    m = np.array([0.2, -0.1])
    ref = jax.jit(lambda: (jgnp.multivariate_normal.logpdf(_PTS, m, _C2),
                           jgnp.multivariate_normal.logpdf(_X, 0.5, 2.0)))()
    _assert_close(tgnp.multivariate_normal.logpdf(_PTS, m, _C2), ref[0])
    _assert_close(tgnp.multivariate_normal.cdf(_PTS, m, _C2),
                  jgnp.multivariate_normal.cdf(_PTS, m, _C2))
    _assert_close(tgnp.multivariate_normal.logpdf(_X, 0.5, 2.0), ref[1])
    _assert_close(tgnp.multivariate_normal.cdf(_X, 0.5, 2.0),
                  jgnp.multivariate_normal.cdf(_X, 0.5, 2.0))


def test_draws_by_moments():
    n = 40000
    g = torch.Generator().manual_seed(5)
    z = tgnp.normal.rvs(1.0, 2.0, size=n, generator=g)
    assert z.shape == (n,)
    assert abs(float(z.mean()) - 1.0) < 4 * 2.0 / np.sqrt(n)
    assert abs(float(z.std()) - 2.0) < 0.05
    m = np.array([0.5, -1.0])
    Z = tgnp.multivariate_normal.rvs(m, _C2, n=n, generator=g)
    assert Z.shape == (n, 2)
    np.testing.assert_allclose(_np(Z.mean(0)), m, atol=4 * np.sqrt(2.0 / n))
    np.testing.assert_allclose(np.cov(_np(Z).T), _C2, atol=0.05)
    assert tgnp.multivariate_normal.rvs(m, _C2, generator=g).shape == (2,)
    assert tgnp.multivariate_normal.rvs(0.0, 4.0, n=n, generator=g).std() > 1.9
    s = tgnp.MultivariateNormal(m, _C2).sample((n,), generator=g)
    np.testing.assert_allclose(np.cov(_np(s).T), _C2, atol=0.05)
    s = tgnp.Normal(np.zeros(3), 1.0).sample((n,), generator=g)
    assert s.shape == (n, 3) and abs(float(s.std()) - 1.0) < 0.02
    # the module generator, reseeded, repeats itself
    tgnp.set_seed(3)
    a = tgnp.normal.rvs(size=5)
    tgnp.set_seed(3)
    assert torch.equal(a, tgnp.normal.rvs(size=5))


# ----------------------------------------------------------------------------
# Criterion wrappers
# ----------------------------------------------------------------------------
def _data(n=40, d=2, seed=3):
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(n, d))
    zi = np.sin(5.0 * xi[:, 0]) * np.cos(3.0 * xi[:, 1]) + 0.05 * rng.normal(size=n)
    return xi, zi


def _models():
    def mean(gnp):
        return lambda x, p: gnp.ones((x.shape[0], 1))

    def jk(x, y, c, pairwise=False):
        return jgp.kernel.maternp_covariance(x, y, 2, c, pairwise)

    def tk(x, y, c, pairwise=False):
        return tgp.kernel.maternp_covariance(x, y, 2, c, pairwise)

    return jgp.Model(mean(jgnp), jk), tgp.Model(mean(tgnp), tk)


def _reml(pkg):
    return lambda m, c, x, z: pkg.kernel.negative_log_restricted_likelihood(m, c, x, z)


def test_evaluate_batch_rows_and_jax():
    xi, zi = _data()
    jm, tm = _models()
    jcrit = jgnp.DifferentiableSelectionCriterion(
        lambda c, x, z: _reml(jgp)(jm, c, x, z), xi, zi)
    tcrit = tgnp.DifferentiableSelectionCriterion(
        lambda c, x, z: _reml(tgp)(tm, c, x, z), xi, zi)
    P = np.column_stack([np.linspace(-1.0, 1.0, 9), np.full(9, 2.0), np.linspace(1.5, 2.5, 9)])
    P[4] = [np.nan, 1.2, 1.0]  # a NaN value, mapped to +inf
    vals = tcrit.evaluate_batch(P)
    assert isinstance(vals, np.ndarray) and vals.shape == (9,)
    assert vals[4] == np.inf
    rows = np.array([tcrit.evaluate_no_grad(p) for p in P])
    assert np.array_equal(vals, rows)
    assert np.array_equal(vals, np.array([tcrit(p) for p in P]))
    ref = np.asarray(jcrit.evaluate_batch(P), dtype=float)
    ref = np.where(np.isfinite(ref), ref, np.inf)
    _assert_close(vals, ref)


def test_batch_criterion_matches_jax():
    xi, zi = _data(n=90)
    jm, tm = _models()
    loader = [(xi[i:i + 30], zi[i:i + 30]) for i in range(0, 90, 30)]
    p = np.array([-0.3, 2.0, 2.0])
    for reduction, bpe in (("mean", 0), ("sum", 0), ("mean", 2)):
        j = jgnp.BatchDifferentiableSelectionCriterion(
            lambda c, x, z: _reml(jgp)(jm, c, x, z), loader, reduction, bpe)
        t = tgnp.BatchDifferentiableSelectionCriterion(
            lambda c, x, z: _reml(tgp)(tm, c, x, z), loader, reduction, bpe)
        for _ in range(2):  # bpe = 2 cycles through the three batches
            jv, tv = j.evaluate(p), t.evaluate(p)
            assert abs(tv - jv) <= 1e-10 * abs(jv)
            _assert_close(t.gradient(p), np.asarray(j.gradient(p)), 1e-10)
        assert abs(t(p) - j(p)) <= 1e-10 * abs(j(p))
    with pytest.raises(ValueError):
        tgnp.BatchDifferentiableSelectionCriterion(None, loader, reduction="max")
    with pytest.raises(ValueError):
        tgnp.BatchDifferentiableSelectionCriterion(lambda c, x, z: c.sum(), []).evaluate(p)


def test_second_order_function_matches_jax():
    xi, zi = _data()
    jm, tm = _models()
    p = np.array([-0.2, 1.3, 0.7])
    jf = jgnp.SecondOrderDifferentiableFunction(lambda c: _reml(jgp)(jm, c, xi, zi))
    tf = tgnp.SecondOrderDifferentiableFunction(lambda c: _reml(tgp)(tm, c, xi, zi))
    jv = jf.evaluate(p)
    jg = jf.gradient()
    _assert_close(tf.evaluate(p), jv, 1e-10)
    _assert_close(tf.gradient(), jg, 1e-10)
    _assert_close(tf.hessian(), jf.hessian(), 1e-10)
    _assert_close(tgnp.grad(lambda c: _reml(tgp)(tm, c, xi, zi))(p), jg, 1e-10)
    v, g = tgnp.value_and_grad(lambda c: _reml(tgp)(tm, c, xi, zi), p)
    _assert_close(v, jv, 1e-10)
    _assert_close(g, jg, 1e-10)


def test_second_order_function_retries_mixed_engine_on_f64(caplog):
    """n = 200 engages the mixed engine, whose Functions have no second-order
    rule: the Hessian is computed again on the f64 engine, logged once."""
    xi, zi = _data(n=200)
    _, tm = _models()
    p = np.array([-0.2, 1.3, 0.7])
    f = lambda c: _reml(tgp)(tm, c, xi, zi)  # noqa: E731
    H64 = tgnp.SecondOrderDifferentiableFunction(f)
    H64.evaluate(p)
    ref = H64.hessian()
    prev = config.get_chol_engine()
    config.set_chol_engine("mixed")
    try:
        tf = tgnp.SecondOrderDifferentiableFunction(f)
        tf.evaluate(p)
        with caplog.at_level(logging.WARNING, logger="gpmp_tpu_torch"):
            H = tf.hessian()
            H2 = tf.hessian()
        assert config.get_chol_engine() == "mixed"
    finally:
        config.set_chol_engine(prev)
    msgs = [r.getMessage() for r in caplog.records if "f64 engine" in r.getMessage()]
    assert len(msgs) == 1
    assert torch.equal(H, ref) and torch.equal(H2, ref)
    assert bool(torch.all(torch.isfinite(H)))
