# tests/test_torch_remap.py
"""The port's REMAP, priors, prior defaults and helpers, empirical bounds,
``method='lbfgs-device'`` and loader-sourced criteria, against gpmp_tpu on
the same NumPy inputs, on the CPU in f64.

- The priors and the five REMAP objectives: value and gradient against
  ``jax.value_and_grad`` (jitted) at 1e-10 relative (max|diff| / max|ref|),
  ``neglog_f_logrho`` inside, at and outside its support (+inf values, a
  finite gradient), ``log_prior_reference`` through a differentiable Fisher
  (its gradient a third derivative of the covariance).
- ``compute_logrho_min_from_xi``, ``empirical_bounds_factory`` and the
  prior-default resolution: exactly.
- The eight REMAP procedures on example02's and example20's data: the
  fitted criteria to 1e-9 relative, covparam at the criterion's flatness
  (1e-4: two SLSQP runs land ~1e-7 apart in the parameters).
- Mesh-mode REMAP: tests/test_torch_parallel.py, beside the mesh's other
  paths.
- ``lbfgs-device`` on tests/test_selection.py's problem: J within
  1e-6 max(1, |J|) of gpmp_tpu's lbfgs-device and of the port's L-BFGS-B.
- A loader's criterion (``batches_per_eval`` 0 and 2) and
  ``make_data_parallel_criterion`` on a one-device mesh: 1e-10.
"""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.kernel  # noqa: F401
import gpmp_tpu.num as jgnp
from gpmp_tpu import dataloader as jdl
from gpmp_tpu.kernel import prior_defaults as jpd
from gpmp_tpu.kernel import prior_helpers as jph
from gpmp_tpu.parallel import make_data_parallel_criterion as j_dp_criterion
from gpmp_tpu.parallel import make_mesh as jmake_mesh
from gpmp_tpu.parallel import shard_batches as j_shard_batches
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch import dataloader as tdl
from gpmp_tpu_torch.kernel import prior_defaults as tpd
from gpmp_tpu_torch.kernel import prior_helpers as tph
from gpmp_tpu_torch.parallel import make_data_parallel_criterion as t_dp_criterion
from gpmp_tpu_torch.parallel import make_mesh, shard_batches

TOL = 1e-10
TOL_FIT = 1e-9   # fitted criteria
TOL_PARAM = 1e-4  # fitted covparam: the criterion's flatness


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


def _model(gp, gnp, p=2):
    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, p, covparam, pairwise)

    return gp.Model(mean, kernel)


_R = np.random.default_rng(20261018)
XI = _R.uniform(size=(15, 2))
ZI = np.sin(3.0 * XI[:, 0]) + 0.5 * XI[:, 1]
P = np.array([0.3, 0.5, -0.2])
LOGRHO_MIN = np.array([-2.0, -1.5])
LOGRHO_0 = np.array([-0.6, 0.1])


def _value_and_grad_both(jfun, tfun, p=P):
    jv, jg = jax.jit(jax.value_and_grad(jfun))(jgnp.asarray(p))
    return _torch_value_and_grad(tfun, p), (float(jv), np.asarray(jg))


def _torch_value_and_grad(tfun, p=P):
    pt = torch.tensor(p, dtype=torch.float64, requires_grad=True)
    tv = tfun(pt)
    (tg,) = torch.autograd.grad(tv, pt)
    return float(tv.detach()), tg


@functools.lru_cache(maxsize=None)
def _jax_values_and_grads(table):
    """{name: (value, grad)} of every function of PRIORS or POSTERIORS at P,
    gpmp_tpu's, from one jitted program (one compilation for the table)."""
    funs = _jax_table(table)
    run = jax.jit(lambda c: {k: jax.value_and_grad(f)(c) for k, f in funs.items()})
    return {k: (float(v), np.asarray(g)) for k, (v, g) in run(jgnp.asarray(P)).items()}


# --------------------------------------------------------------------------
# the priors
# --------------------------------------------------------------------------
PRIORS = {
    "jeffreys_variance": lambda k, c: k.log_prior_jeffreys_variance(c, 1.5),
    "power_law": lambda k, c: k.log_prior_power_law(c, lambda_lengthscales=0.5),
    # every cutoff crossed: the linear penalties' slopes
    "power_law_cutoffs": lambda k, c: k.log_prior_power_law(
        c, cut_logvariance_high=0.1, cut_loginvrho_low=0.0, cut_loginvrho_high=0.2,
        penalty_factor=30),
    "gaussian_logsigma2": lambda k, c: k.log_prior_gaussian_logsigma2(
        c, -0.4, gamma=2.0, sigma2_coverage=0.9),
    "gaussian_logsigma2_defaults": lambda k, c: k.log_prior_gaussian_logsigma2(c, -0.4),
    "logrho_barrier_linear": lambda k, c: k.log_prior_logrho_barrier_linear(
        c, LOGRHO_MIN, LOGRHO_0, alpha=0.7),
    "logrho_barrier_linear_defaults": lambda k, c: k.log_prior_logrho_barrier_linear(
        c, LOGRHO_MIN, LOGRHO_0),
}


def _jax_table(table):
    if table == "priors":
        return {k: functools.partial(f, jgp.kernel) for k, f in PRIORS.items()}
    jm, xj, zj = _model(jgp, jgnp), jgnp.asarray(XI), jgnp.asarray(ZI)
    return {k: (lambda c, f=f: f(jgp.kernel, jm, c, xj, zj)) for k, f in POSTERIORS.items()}


@pytest.mark.parametrize("name", sorted(PRIORS))
def test_log_prior_matches_jax(name):
    f = PRIORS[name]
    jv, jg = _jax_values_and_grads("priors")[name]
    tv, tg = _torch_value_and_grad(lambda c: f(tgp.kernel, c))
    assert abs(tv - jv) <= TOL * max(abs(jv), 1e-300)
    assert _relmax(tg, jg) <= TOL


def test_neglog_f_logrho_inside_at_and_outside_the_support():
    """u = logrho - logrho_min at 1 (inside), 0 (on the barrier) and -0.5
    (outside): the penalty is finite, +inf and +inf, and the gradient of
    the sum stays finite (the u_safe substitution), as in gpmp_tpu."""
    lmin = np.array([-2.0, -1.5, -2.5])
    l0 = np.array([-0.6, 0.1, -1.0])
    logrho = np.array([-1.0, -1.5, -3.0])
    jf = jax.jit(lambda lr: jgp.kernel.neglog_f_logrho(lr, lmin, l0, alpha=0.7))
    jv = np.asarray(jf(jgnp.asarray(logrho)))
    jg = np.asarray(jax.grad(lambda lr: jgnp.sum(jf(lr)))(jgnp.asarray(logrho)))
    lt = torch.tensor(logrho, requires_grad=True)
    tv = tgp.kernel.neglog_f_logrho(lt, lmin, l0, alpha=0.7)
    (tg,) = torch.autograd.grad(torch.sum(tv), lt)
    tv = tv.detach().numpy()
    assert np.isfinite(tv[0]) and np.isinf(tv[1:]).all() and (tv[1:] > 0).all()
    np.testing.assert_array_equal(np.isinf(tv), np.isinf(jv))
    assert abs(tv[0] - jv[0]) <= TOL * abs(jv[0])
    assert np.isfinite(tg.numpy()).all()
    assert _relmax(tg, jg) <= TOL
    # logrho_0 must lie above logrho_min, in both packages
    for k in (jgp.kernel, tgp.kernel):
        with pytest.raises(ValueError, match="logrho_0 must be > logrho_min"):
            k.neglog_f_logrho(np.zeros(3), lmin, lmin)
        with pytest.raises(ValueError, match="alpha"):
            k.neglog_f_logrho(np.zeros(3), lmin, l0, alpha=0.0)


POSTERIORS = {
    "with_jeffreys_prior": lambda k, m, c, x, z: (
        k.neg_log_restricted_posterior_with_jeffreys_prior(m, c, x, z, lambda_var=1.5)),
    "power_laws_prior": lambda k, m, c, x, z: (
        k.neg_log_restricted_posterior_power_laws_prior(m, c, x, z)),
    "logsigma2_prior": lambda k, m, c, x, z: (
        k.neg_log_restricted_posterior_logsigma2_prior(m, c, x, z, log_sigma2_0=-0.4)),
    "with_logrho_prior": lambda k, m, c, x, z: (
        k.neg_log_restricted_posterior_with_logrho_prior(
            m, c, x, z, logrho_min=LOGRHO_MIN, logrho_0=LOGRHO_0, alpha=0.7)),
    "logsigma2_and_logrho_prior": lambda k, m, c, x, z: (
        k.neg_log_restricted_posterior_logsigma2_and_logrho_prior(
            m, c, x, z, log_sigma2_0=-0.4, logrho_min=LOGRHO_MIN, logrho_0=LOGRHO_0)),
}


@pytest.mark.parametrize("name", sorted(POSTERIORS))
def test_neg_log_restricted_posterior_matches_jax(name):
    f = POSTERIORS[name]
    tm = _model(tgp, tgnp)
    jv, jg = _jax_values_and_grads("posteriors")[name]
    tv, tg = _torch_value_and_grad(lambda c: f(tgp.kernel, tm, c, XI, ZI))
    assert abs(tv - jv) <= TOL * abs(jv)
    assert _relmax(tg, jg) <= TOL


def test_default_remap_objective_needs_logrho_bounds():
    for gp, gnp in ((jgp, jgnp), (tgp, tgnp)):
        with pytest.raises(ValueError, match="logrho_min and logrho_0"):
            gp.kernel.neg_log_restricted_posterior_logsigma2_and_logrho_prior(
                _model(gp, gnp), gnp.asarray(P), XI, ZI, log_sigma2_0=0.0)


def test_log_prior_reference_value_and_gradient():
    """0.5 log det I(theta): the value, and a gradient that matches jax.grad
    (a third derivative of the covariance through the gram's plain
    composition), never a silent zero."""
    jm, tm = _model(jgp, jgnp), _model(tgp, tgnp)
    xj = jgnp.asarray(XI)
    (tv, tg), (jv, jg) = _value_and_grad_both(
        lambda c: jgp.kernel.log_prior_reference(jm, c, xj),
        lambda c: tgp.kernel.log_prior_reference(tm, c, XI))
    assert abs(tv - jv) <= TOL * abs(jv)
    assert _relmax(tg, jg) <= TOL
    assert float(torch.max(torch.abs(tg))) > 1e-3
    # without a graph, the same value
    with torch.no_grad():
        v = tgp.kernel.log_prior_reference(tm, torch.tensor(P), XI)
    assert abs(float(v) - jv) <= TOL * abs(jv)


# --------------------------------------------------------------------------
# the host helpers, exactly
# --------------------------------------------------------------------------
def _geometry_cases():
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(12, 3))
    x[5] = x[2]           # a repeated point
    x[:, 2] = 0.25        # a constant column: no positive gap, zero range
    return {"uniform": XI, "repeats_and_constant": x,
            "one_point": np.array([[0.2, 0.4]])}


@pytest.mark.parametrize("case", sorted(_geometry_cases()))
def test_logrho_min_and_empirical_bounds_exact(case):
    x = _geometry_cases()[case]
    z = np.cos(np.arange(x.shape[0], dtype=float))
    for factor in (None, 0.2):
        j = jgp.kernel.compute_logrho_min_from_xi(jgnp.asarray(x), factor)
        t = tgp.kernel.compute_logrho_min_from_xi(x, factor)
        np.testing.assert_array_equal(tgnp.to_np(t), np.asarray(j))
    for kw in ({}, dict(mean_paramlength=2, var_lower_factor=0.5, length_lower_factor=3.0)):
        j = jgp.kernel.empirical_bounds_factory(x, z, **kw)
        t = tgp.kernel.empirical_bounds_factory(x, z, **kw)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(tgnp.to_np(t), np.asarray(j))
    for k in (jgp.kernel, tgp.kernel):
        with pytest.raises(ValueError, match="rho_min_range_factor"):
            k.compute_logrho_min_from_xi(x, 0.0)


@pytest.fixture
def _defaults_restored():
    saved = (jpd.get_default_prior_hyperparameters(), tpd.get_default_prior_hyperparameters())
    yield
    jpd.set_default_prior_hyperparameters(**saved[0])
    tpd.set_default_prior_hyperparameters(**saved[1])


def test_prior_defaults_registry(_defaults_restored):
    assert tpd.get_default_prior_hyperparameters() == jpd.get_default_prior_hyperparameters()
    # the port's registry is its own
    tpd.set_default_prior_hyperparameters(alpha=2.5, gamma=None)
    assert tpd.get_default_prior_hyperparameters()["alpha"] == 2.5
    assert jpd.get_default_prior_hyperparameters()["alpha"] == 1.0
    for mod in (jpd, tpd):
        kw = {"prior_logsigma2_gamma": 3.0, "prior_logrho_min_range_factor": 0.1,
              "other": 1}
        mod.set_default_prior_hyperparameters_from_kwargs(kw)
        assert kw == {"other": 1}
        with pytest.raises(ValueError, match="gamma must be > 1"):
            mod.set_default_prior_hyperparameters(gamma=1.0)
        with pytest.raises(ValueError, match="sigma2_coverage"):
            mod.set_default_prior_hyperparameters(sigma2_coverage=1.0)
        with pytest.raises(TypeError, match="unknown prior hyperparameter"):
            mod.set_default_prior_hyperparameters(beta=1.0)
        with pytest.raises(ValueError, match="shape"):
            mod.get_default_prior_hyperparameters(np.zeros(3))
    jpd.set_default_prior_hyperparameters(alpha=2.5)
    assert tpd.get_default_prior_hyperparameters() == jpd.get_default_prior_hyperparameters()


def test_prior_resolution_exact(_defaults_restored):
    """resolve_prior_defaults_for_selection and
    resolve_logsigma2_logrho_prior_args from arrays and from a loader
    (logrho_min from the loader's shards), with explicit and default
    values."""
    for mod in (jpd, tpd):
        mod.set_default_prior_hyperparameters(gamma=1.7, rho_min_range_factor=0.08)
    jloader = jdl.DataLoader(jdl.Dataset([jgnp.asarray(XI[:6]), jgnp.asarray(XI[6:])],
                                         [jgnp.asarray(ZI[:6]), jgnp.asarray(ZI[6:])]), 5)
    tloader = tdl.DataLoader(tdl.Dataset([XI[:6], XI[6:]], [ZI[:6], ZI[6:]]), 5)
    for kw in ({}, dict(gamma=2.0, alpha=0.3), dict(sigma2_coverage=0.5)):
        assert (tpd.resolve_prior_defaults_for_selection(xi=XI, **kw)
                == jpd.resolve_prior_defaults_for_selection(xi=XI, **kw))
        assert (tpd.resolve_prior_defaults_for_selection(dataloader=tloader, **kw)
                == jpd.resolve_prior_defaults_for_selection(dataloader=jloader, **kw))
    cp0 = np.array([0.2, 0.7, -0.1])
    for src in ("arrays", "loader"):
        for kw in ({}, dict(prior_alpha=0.5, prior_logrho_0=np.array([0.3, 0.4]),
                            prior_log_sigma2_0=-1.0, prior_rho_min_range_factor=0.3)):
            data_j = dict(xi=jgnp.asarray(XI)) if src == "arrays" else dict(dataloader=jloader)
            data_t = dict(xi=XI) if src == "arrays" else dict(dataloader=tloader)
            j = jph.resolve_logsigma2_logrho_prior_args(covparam0_prior=jgnp.asarray(cp0),
                                                        **data_j, **kw)
            t = tph.resolve_logsigma2_logrho_prior_args(covparam0_prior=cp0, **data_t, **kw)
            for a, b in zip(t, j):
                np.testing.assert_array_equal(np.asarray(tgnp.to_np(a), dtype=float),
                                              np.asarray(b, dtype=float))


def test_prior_anchor_roles_and_implicit_anchor_warning():
    jm, tm = _model(jgp, jgnp, 3), _model(tgp, tgnp, 3)
    cp, cp2 = np.array([0.1, 0.2, 0.3]), np.array([-0.1, 0.4, 0.0])
    # a fresh selection: explicit roles win, then covparam0, then the
    # initial guess (computed once for both roles; the guess itself is held
    # to gpmp_tpu's by the REMAP procedures' fits below and in
    # tests/test_torch_meanparam.py)
    guess = tgnp.to_np(tgp.kernel.anisotropic_parameters_initial_guess(tm, XI, ZI))
    for kw, want in (({}, (guess, guess)), (dict(covparam0=cp), (cp, cp)),
                     (dict(covparam0=cp, covparam0_init=cp2), (cp, cp2)),
                     (dict(covparam0_prior=cp2, covparam0_init=cp), (cp2, cp)),
                     (dict(covparam0_prior=cp2), (cp2, guess))):
        for got, w in zip(tph.resolve_covparam0_prior_and_init(tm, XI, ZI, **kw), want):
            np.testing.assert_array_equal(tgnp.to_np(got), w)
    # an update: the implicit anchor warns, in the same words
    msgs = []
    for mod, m in ((jph, jm), (tph, tm)):
        m.covparam = cp
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            p, i = mod.resolve_covparam0_roles_for_update(m, XI, ZI)
        np.testing.assert_array_equal(np.asarray(tgnp.to_np(p)), cp)
        msgs.append([str(w.message) for w in rec])
    assert msgs[0] == msgs[1] and len(msgs[0]) == 1


# --------------------------------------------------------------------------
# the eight REMAP procedures
# --------------------------------------------------------------------------
def _dataset(name):
    gp = jgp
    if name == "example02":
        xi = gp.misc.designs.ldrandunif(1, 6, [[-1], [1]], seed=42)
    else:  # example20's first draw
        xi = gp.misc.designs.ldrandunif(1, 8, [[-1], [1]], seed=100)
    xi = np.asarray(xi)
    return xi, np.asarray(gp.misc.testfunctions.twobumps(xi))


# the four select_* procedures on example02's data, the four update_* on
# example20's (select_parameters_with_remap on example20's data is
# tests/test_torch_examples.py's example 20 twin)
PROCEDURES = (
    ("select_parameters_with_remap", "example02"),
    ("update_parameters_with_remap", "example20"),
    ("select_parameters_with_remap_with_power_laws_prior", "example02"),
    ("update_parameters_with_remap_with_power_laws_prior", "example20"),
    ("select_parameters_with_remap_gaussian_logsigma2", "example02"),
    ("update_parameters_with_remap_gaussian_logsigma2", "example20"),
    ("select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior", "example02"),
    ("update_parameters_with_remap_gaussian_logsigma2_and_logrho_prior", "example20"),
)


@pytest.mark.parametrize("proc,data", PROCEDURES)
def test_remap_procedure_matches_jax(proc, data):
    xi, zi = _dataset(data)
    start = np.array([0.5, 0.8])  # the update procedures' model.covparam
    fits = {}
    for gp, gnp in ((jgp, jgnp), (tgp, tgnp)):
        m = _model(gp, gnp, 3)
        if proc.startswith("update"):
            m.covparam = gnp.asarray(start)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the implicit anchor's warning
            m, info = getattr(gp.kernel, proc)(m, xi, zi, info=True)
        fits[gp] = (np.asarray(gnp.to_np(m.covparam)), info)
    (tc, ti), (jc, ji) = fits[tgp], fits[jgp]
    assert isinstance(ti["covparam"], np.ndarray)
    assert abs(ti.fun - ji.fun) <= TOL_FIT * abs(ji.fun)
    np.testing.assert_allclose(tc, jc, atol=TOL_PARAM)


# --------------------------------------------------------------------------
# lbfgs-device
# --------------------------------------------------------------------------
def _noisy_problem(gp, gnp):
    rng = np.random.default_rng(3)
    xi = rng.uniform(size=(120, 2))
    zi = np.sin(3 * xi[:, 0]) + 0.1 * rng.normal(size=120)

    def mean(x, p):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, p, pairwise=False):
        s2, noise, li = gnp.exp(p[0]), gnp.exp(p[1]), p[2:]
        if y is x or y is None:
            if pairwise:
                return (s2 + noise) * gnp.ones((x.shape[0],))
            K = gnp.scaled_distance(li, x, x)
            return s2 * gp.kernel.maternp_kernel(2, K) + noise * gnp.eye(K.shape[0])
        K = (gnp.scaled_distance_elementwise if pairwise else gnp.scaled_distance)(li, x, y)
        return s2 * gp.kernel.maternp_kernel(2, K)

    return gp.kernel.make_selection_criterion_with_gradient(
        gp.Model(mean, kernel), gp.kernel.negative_log_restricted_likelihood,
        gnp.asarray(xi), gnp.asarray(zi))


def test_lbfgs_device_matches_jax_and_scipy():
    p0 = np.array([0.0, np.log(0.01), 0.0, 0.0])
    _c, pre_j, _n, grad_j = _noisy_problem(jgp, jgnp)
    _c, pre_t, _n, grad_t = _noisy_problem(tgp, tgnp)
    _x, r_j = jgp.kernel.autoselect_parameters(p0, pre_j, grad_j, method="lbfgs-device",
                                               info=True)
    x_t, r_t = tgp.kernel.autoselect_parameters(p0, pre_t, grad_t, method="lbfgs-device",
                                                info=True)
    _x, r_s = tgp.kernel.autoselect_parameters(p0, pre_t, grad_t, method="L-BFGS-B",
                                               info=True)
    scale = max(1.0, abs(r_s.fun))
    assert abs(r_t.fun - r_j.fun) <= 1e-6 * scale
    assert r_t.fun <= r_s.fun + 1e-6 * scale
    assert r_t.best_value_returned and r_t.success and r_t.message == "lbfgs-device"
    assert r_t.nit > 0 and len(r_t.history_params) == 2 and len(r_t.history_criterion) == 2
    np.testing.assert_array_equal(r_t.initial_params, p0)
    assert isinstance(x_t, np.ndarray) and np.array_equal(x_t, r_t.final_params)
    assert r_t.history_criterion[1] == r_t.fun < r_t.history_criterion[0]


def test_lbfgs_device_bounds_fallback_and_refusal():
    p0 = np.array([0.0, np.log(0.01), 0.0, 0.0])
    _c, pre, _n, grad = _noisy_problem(tgp, tgnp)
    bounds = [(p - 0.25, p + 0.25) for p in p0]
    x, r = tgp.kernel.autoselect_parameters(p0, pre, grad, bounds=bounds,
                                            method="lbfgs-device", info=True)
    lo, hi = np.array(bounds).T
    assert np.all(x >= lo) and np.all(x <= hi) and r.fun < r.history_criterion[0]
    # a start where the criterion is +inf: no step is taken, p0 comes back
    def bad(p):
        return torch.full((), float("nan"), dtype=p.dtype) + 0.0 * p.sum()
    x, r = tgp.kernel.autoselect_parameters(p0, bad, None, method="lbfgs-device",
                                            info=True, method_options={"chunk_size": 3})
    np.testing.assert_array_equal(x, p0)
    assert not r.best_value_returned and r.nit == 0
    with pytest.raises(TypeError, match="lbfgs-device"):
        tgp.kernel.autoselect_parameters(p0, lambda p: 1.0, None, method="lbfgs-device")


# --------------------------------------------------------------------------
# a loader's criterion and the data-parallel criterion
# --------------------------------------------------------------------------
def _loader_data(n=90, d=2, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    return x, np.sin(3 * x[:, 0]) + 0.5 * np.cos(4 * x[:, 1])


@pytest.mark.parametrize("bpe", (0, 2))
def test_loader_criterion_matches_jax(bpe):
    """make_selection_criterion_with_gradient(dataloader=...): a shuffled
    loader (a new epoch, so new batches, at each full pass; the port's
    dataset sharded, gpmp_tpu's not: the same batches), value and gradient
    at successive evaluations."""
    x, z = _loader_data()
    jds = jdl.Dataset(jgnp.asarray(x), jgnp.asarray(z))
    tds = tgp.interop.dataset_from_numpy([x[:40], x[40:]], [z[:40], z[40:]],
                                         device="cpu", dtype=torch.float64)
    jl = jdl.DataLoader(jds, batch_size=30, shuffle=True, seed=3)
    tl = tdl.DataLoader(tds, batch_size=30, shuffle=True, seed=3)
    fj = jgp.kernel.make_selection_criterion_with_gradient(
        _model(jgp, jgnp), jgp.kernel.negative_log_restricted_likelihood,
        dataloader=jl, batches_per_eval=bpe)
    ft = tgp.kernel.make_selection_criterion_with_gradient(
        _model(tgp, tgnp), tgp.kernel.negative_log_restricted_likelihood,
        dataloader=tl, batches_per_eval=bpe)
    for k in range(2):
        p = P + 0.1 * k
        jv, tv = fj[0](p), ft[0](p)
        assert abs(tv - jv) <= TOL * abs(jv)
        assert _relmax(ft[3](p), fj[3](p)) <= TOL  # the cached gradient
        assert abs(ft[2](p) - fj[2](p)) <= TOL * abs(jv)  # no-grad: one more pass
    with pytest.raises(ValueError, match="not both"):
        tgp.kernel.make_selection_criterion_with_gradient(
            _model(tgp, tgnp), tgp.kernel.negative_log_restricted_likelihood, x, z,
            dataloader=tl)


def test_data_parallel_criterion_on_one_device_mesh_matches_jax():
    x, z = _loader_data(n=96)
    jmesh = jmake_mesh(1, axis_name="batch")
    jxb, jzb = j_shard_batches(x, z, 4, mesh=jmesh)
    txb, tzb = shard_batches(x, z, 4, mesh=make_mesh(1))
    assert tuple(txb.shape) == (4, 24, 2) and tuple(tzb.shape) == (4, 24)
    np.testing.assert_array_equal(txb.numpy(), np.asarray(jxb))
    jm, tm = _model(jgp, jgnp), _model(tgp, tgnp)
    jvg = j_dp_criterion(lambda p, xs, zs: jgp.kernel.negative_log_restricted_likelihood(
        jm, p, xs, zs), jmesh)
    tvg = t_dp_criterion(lambda p, xs, zs: tgp.kernel.negative_log_restricted_likelihood(
        tm, p, xs, zs), make_mesh(1))
    jv, jg = jvg(jgnp.asarray(P), jxb, jzb)
    tv, tg = tvg(P, txb, tzb)
    assert abs(float(tv) - float(jv)) <= TOL * abs(float(jv))
    assert _relmax(tg, np.asarray(jg)) <= TOL
    # the same as the loader criterion on the same (unshuffled) batches
    tl = tdl.DataLoader(tdl.Dataset(x, z), 24, shuffle=False)
    crit = tgp.kernel.make_selection_criterion_with_gradient(
        tm, tgp.kernel.negative_log_restricted_likelihood, dataloader=tl)
    assert abs(crit[0](P) - float(tv)) <= 1e-12 * abs(float(tv))
    assert _relmax(tg, crit[3](P)) <= 1e-12
    with pytest.raises(ValueError, match="n_batches larger"):
        shard_batches(x[:3], z[:3], 4)
