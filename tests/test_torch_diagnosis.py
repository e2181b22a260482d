# tests/test_torch_diagnosis.py
"""The diagnosis flow of example02 through the port, against gpmp_tpu.

On the CPU in f64: the example02 twin (fit, ``modeldiagnosis.diag``,
predict) beside gpmp_tpu's example02, then, at gpmp_tpu's fitted covparam
on both sides, the report, the performance tables, the parameter
statistics (through ``evaluate_batch``), the scoring rules, ``Param``,
Fisher information (the four functions) and the plots (Agg backend).

Bars: the fits at the criterion's flatness (the criteria to 1e-9, the
parameters to 1e-5: two SLSQP runs land ~1e-7 apart); the report and the
performance tables print the same text, the time of the fit aside; the
numbers at a fixed covparam to 1e-9; the scoring rules to 1e-12; Fisher
to 1e-9 for the built-in Matern and for a user kernel that composes
``gnp.scaled_distance``, at n <= 60.
"""

import contextlib
import io
import os
import sys

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import gpmp_tpu as jgp  # noqa: E402
import gpmp_tpu.kernel  # noqa: E402,F401
import gpmp_tpu.modeldiagnosis as jmd  # noqa: E402
import gpmp_tpu.num as jgnp  # noqa: E402
import gpmp_tpu.parameter as jparam  # noqa: E402
from gpmp_tpu.core import fisher as jfisher  # noqa: E402
from gpmp_tpu.misc import scoringrules as jsr  # noqa: E402
import gpmp_tpu_torch as tgp  # noqa: E402
import gpmp_tpu_torch.kernel  # noqa: E402,F401
import gpmp_tpu_torch.modeldiagnosis as tmd  # noqa: E402
import gpmp_tpu_torch.num as tgnp  # noqa: E402
import gpmp_tpu_torch.parameter as tparam  # noqa: E402
from gpmp_tpu_torch import config  # noqa: E402
from gpmp_tpu_torch.core import fisher as tfisher  # noqa: E402
from gpmp_tpu_torch.misc import scoringrules as tsr  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import examples.gpmp_tpu_example02_1d_interpolation as jex02  # noqa: E402
import examples.gpmp_tpu_torch_example02_1d_interpolation as tex02  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _rel(a, b):
    a = np.asarray(tgnp.to_np(a), dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def _without_time(text):
    return [line for line in text.splitlines() if not line.strip().startswith("time:")]


@pytest.fixture(scope="module")
def ex02():
    """Both packages' example02 (fit, diag, predict), their printed output,
    and the data; the port's model then takes gpmp_tpu's covparam."""
    config.set_device("cpu")
    torch.set_num_threads(2)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jres = jex02.main(show=False)
    with contextlib.redirect_stdout(tbuf):
        tres = tex02.main(show=False)
    xt, zt, xi, zi = jex02.generate_data()
    return dict(j=jres, t=tres, jout=jbuf.getvalue(), tout=tbuf.getvalue(),
                xi=xi, zi=zi, xt=xt, zt=zt)


def test_example02_twin_matches_jax(ex02):
    jm, jinfo, jzpm, jzpv = ex02["j"]
    tm, tinfo, tzpm, tzpv = ex02["t"]
    assert tinfo.nfev == jinfo.nfev
    assert abs(tinfo.fun - jinfo.fun) <= 1e-9 * abs(jinfo.fun)
    np.testing.assert_allclose(tgnp.to_np(tm.covparam), np.asarray(jm.covparam), atol=1e-5)
    assert _rel(tzpm, jzpm) <= 1e-6 and _rel(tzpv, jzpv) <= 1e-5
    # the report prints the same tables
    assert _without_time(ex02["tout"]) == _without_time(ex02["jout"])


def _same_covparam(ex02):
    jm, jinfo = ex02["j"][:2]
    tm, tinfo = ex02["t"][:2]
    tm.covparam = tgnp.asarray(np.asarray(jm.covparam))
    return jm, jinfo, tm, tinfo


def test_report_at_a_fixed_covparam(ex02):
    jm, jinfo, tm, tinfo = _same_covparam(ex02)
    tr, jr = tmd.modeldiagnosis_init(tm, tinfo), jmd.modeldiagnosis_init(jm, jinfo)
    assert list(tr["parameters"]) == list(jr["parameters"])
    assert _rel(list(tr["parameters"].values()), list(jr["parameters"].values())) <= 1e-12
    tb, jb = tr["param_obj"].bounds, jr["param_obj"].bounds
    assert [b is None for b in tb] == [b is None for b in jb]
    assert _rel([b for b in tb if b is not None], [b for b in jb if b is not None]) <= 1e-12
    for key in ("initial_val", "final_val", "optimal_val"):
        assert abs(tr["param_selection"][key] - jr["param_selection"][key]) <= \
            1e-9 * abs(jr["param_selection"][key])
    xi, zi = ex02["xi"], ex02["zi"]
    assert (_without_time(_printed(tmd.model_diagnosis_disp, tr, xi, zi))
            == _without_time(_printed(jmd.model_diagnosis_disp, jr, xi, zi)))


def test_performance_at_a_fixed_covparam(ex02):
    jm, _, tm, _ = _same_covparam(ex02)
    xi, zi, xt, zt = ex02["xi"], ex02["zi"], ex02["xt"], ex02["zt"]
    jp = jmd.compute_performance(jm, xi, zi, xtzt=(xt, zt), compute_pit=True)
    tp = tmd.compute_performance(tm, xi, zi, xtzt=(xt, zt), compute_pit=True)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert _rel(tp[key], jp[key]) <= 1e-9, key
    assert (_printed(tmd.perf, tm, xi, zi, xtzt=(xt, zt))
            == _printed(jmd.perf, jm, xi, zi, xtzt=(xt, zt)))


def test_parameter_statistics_at_a_fixed_covparam(ex02):
    jm, jinfo, tm, tinfo = _same_covparam(ex02)
    cp = np.asarray(jm.covparam)
    kw = dict(model=None, xi=ex02["xi"], covparam=cp, n_points=60, delta=2.0)
    jfast = jmd.selection_criterion_statistics_fast(
        selection_criterion=jinfo.selection_criterion_nograd, **dict(kw, model=jm))
    tfast = tmd.selection_criterion_statistics_fast(
        selection_criterion=tinfo.selection_criterion_nograd, **dict(kw, model=tm))
    t, j = tfast["parameter_statistics"], jfast["parameter_statistics"]
    assert (t.rownames, t.colnames) == (j.rownames, j.colnames)
    assert _rel(t.data, j.data) <= 1e-9
    assert _rel(tfast["fisher_information"], jfast["fisher_information"]) <= 1e-9
    assert str(t) == str(j)
    jq = jmd.selection_criterion_statistics(
        selection_criterion=jinfo.selection_criterion_nograd, ind=[0],
        model=jm, xi=ex02["xi"], covparam=cp, delta=2.0)
    tq = tmd.selection_criterion_statistics(
        selection_criterion=tinfo.selection_criterion_nograd, ind=[0],
        model=tm, xi=ex02["xi"], covparam=cp, delta=2.0)
    assert _rel(tq["parameter_statistics"].data, jq["parameter_statistics"].data) <= 1e-9


def test_scoring_rules_match_jax():
    rng = np.random.default_rng(16)
    mu, sigma, z = rng.normal(size=20), rng.uniform(0.2, 2.0, 20), rng.normal(size=20)
    crps, h1, ei1 = jax.jit(lambda: (jsr.crps_gaussian(mu, sigma, z), jsr.h1(z),
                                     jsr.ei1_up(mu, sigma, z)))()
    assert _rel(tsr.crps_gaussian(mu, sigma, z), crps) <= 1e-12
    assert _rel(tsr.h1(z), h1) <= 1e-12
    assert _rel(tsr.ei1_up(mu, sigma, z), ei1) <= 1e-12
    assert _rel(tsr.ei2_up(mu, sigma, z), jsr.ei2_up(mu, sigma, z)) <= 1e-12
    for a, b in ((-np.inf, np.inf), (-0.5, np.inf), (-np.inf, 0.7), (-0.5, 0.7)):
        assert _rel(tsr.tcrps_gaussian(mu, sigma, z, a, b),
                    jsr.tcrps_gaussian(mu, sigma, z, a, b)) <= 1e-12, (a, b)


def test_param_round_trips_and_prints_as_jax():
    cp = np.array([0.3, -1.2, 0.8, 2.1])
    for build in ("param_from_covparam_anisotropic", "param_from_covparam_anisotropic_noisy"):
        t = getattr(tparam, build)(cp, None, None, name_prefix="")
        j = getattr(jparam, build)(cp, None, None, name_prefix="")
        assert str(t) == str(j) and repr(t) == repr(j)
        assert t.to_simple_dict() == j.to_simple_dict()
        assert np.array_equal(t.denormalized_values, j.denormalized_values)
    for pkg in (tparam, jparam):
        p = pkg.make_anisotropic_param(values=[np.log(2.0), -np.log(0.5), -np.log(1.5)])
        p.denormalized_values = [4.0, 0.25, 3.0]
        p.set_by_name("sigma2", 1.5)
        p.set_by_path(["covparam", "lengthscale"], [0.3, 0.4])
        p.bounds[0] = (-1.0, 2.0)
        if pkg is tparam:
            t = p
    assert np.array_equal(t.values, p.values) and str(t) == str(p)
    assert str(tparam.Param.concat(t, t[1:])) == str(jparam.Param.concat(p, p[1:]))


def _noisy_kernel(pkg, gnp):
    def kernel(x, y, c, pairwise=False):
        s2, noise, l = gnp.exp(c[0]), gnp.exp(c[1]), c[2:]
        if y is x or y is None:
            if pairwise:
                return (s2 + noise) * gnp.ones((x.shape[0],))
            D = gnp.scaled_distance(l, x, x)
            return s2 * pkg.kernel.maternp_kernel(2, D) + noise * gnp.eye(D.shape[0])
        D = (gnp.scaled_distance_elementwise if pairwise else gnp.scaled_distance)(l, x, y)
        return s2 * pkg.kernel.maternp_kernel(2, D)
    return kernel


def _fisher_models(kind):
    rng = np.random.default_rng(7)
    xi = rng.uniform(size=(60, 3))

    def mean(gnp):
        return lambda x, p: gnp.ones((x.shape[0], 1))

    if kind == "builtin":
        cp = np.array([0.2, 1.0, 0.6, 1.4])
        jk = lambda x, y, c, pairwise=False: jgp.kernel.maternp_covariance(x, y, 2, c, pairwise)  # noqa: E731
        tk = lambda x, y, c, pairwise=False: tgp.kernel.maternp_covariance(x, y, 2, c, pairwise)  # noqa: E731
    else:
        cp = np.array([0.2, np.log(1e-2), 1.0, 0.6, 1.4])
        jk, tk = _noisy_kernel(jgp, jgnp), _noisy_kernel(tgp, tgnp)
    return xi, cp, jgp.Model(mean(jgnp), jk, covparam=cp), tgp.Model(mean(tgnp), tk, covparam=cp)


@pytest.mark.parametrize("kind", ["builtin", "user"])
def test_fisher_information_matches_jax(kind):
    xi, cp, jm, tm = _fisher_models(kind)
    jexact = jax.jit(lambda: (jm.fisher_information(xi), jm.fisher_information_cpd(xi, cp),
                              jm.fisher_information_torch(xi, cp)))()
    pairs = (
        (tm.fisher_information(xi), jexact[0]),
        (tm.fisher_information_cpd(xi, cp), jexact[1]),
        (tm.fisher_information_torch(xi, cp), jexact[2]),
        (tfisher.fisher_information_fd(tm, xi, cp), jfisher.fisher_information_fd(jm, xi, cp)),
    )
    for t, j in pairs:
        assert isinstance(t, torch.Tensor) and t.shape == (cp.size, cp.size)
        assert _rel(t, j) <= 1e-9
    # the exact and the finite-difference Fisher agree to the latter's error
    assert _rel(pairs[0][0], pairs[3][1]) <= 1e-5


def test_plots_render_under_agg(ex02):
    _, jinfo, tm, tinfo = _same_covparam(ex02)
    xi, zi, xt = ex02["xi"], ex02["zi"], ex02["xt"]
    import gpmp_tpu_torch.plot as tplot
    from gpmp_tpu_torch.modeldiagnosis import plotting

    calls = []
    crit = tinfo.selection_criterion_nograd
    be = crit.__self__.evaluate_batch
    crit.__self__.evaluate_batch = lambda P: calls.append(len(P)) or be(P)
    try:
        tmd.plot_selection_criterion_crosssections(info=tinfo, delta=0.8, n_points=12,
                                                   param_names=["sigma^2 (log)", "rho (log)"])
        tmd.plot_selection_criterion_sigma_rho(tm, tinfo, n=6)
    finally:
        del crit.__self__.evaluate_batch
    assert calls == [12, 12, 36]
    P = np.tile(tgnp.to_np(tm.covparam), (5, 1))
    P[:, 1] += np.linspace(-0.5, 0.5, 5)
    assert np.array_equal(plotting._batch_eval(crit, P), np.array([crit(p) for p in P]))
    p = tmd.compute_performance(tm, xi, zi, compute_pit=True)
    tmd.plot_pit_ecdf(p["loo_pit"])
    zpm, zpv = tm.predict(xi, zi, xt)
    fig = tplot.Figure(isinteractive=False)
    fig.plot(xt, ex02["zt"], "k", linewidth=1)
    fig.plotdata(xi, zi)
    fig.plotgp(xt, zpm, zpv, colorscheme="simple")
    fig.xylabels("$x$", "$z$")
    fig.show(grid=True, xlim=[-1.0, 1.0], legend=True)
    tplot.crosssections(tm, xi, zi, np.array([[-1.0], [1.0]]), ind_i=[0, 1], nt=20)
    tplot.plot_loo(zi, *tm.loo(xi, zi)[:2])
    assert plt.get_fignums()
    plt.close("all")
