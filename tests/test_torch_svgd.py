# tests/test_torch_svgd.py
"""The port's annealed SVGD (gpmp_tpu_torch.mcmc.svgd and
sample_from_selection_criterion_svgd) against gpmp_tpu's on the CPU, in
f64.  SVGD draws no random numbers after its start, so both packages run
from the same particles and are compared whole.

- ``rbf_kernel_matrix`` within 1e-14 (even and odd populations, n = 1, a
  given bandwidth, ``bandwidth_min``): the median is the mean of the two
  middle off-diagonal values, as ``jnp.nanmedian``'s.
- ``svgd_step`` within 1e-12 on a Gaussian, with a sampling box that kills
  particles (their log probability -inf) and a preconditioner.
- ``svgd_sample``: tests/test_mcmc.py's Gaussian run (80 particles, 400
  steps) within 1e-9, and its moment check on the port's run; the
  parameter-posterior entry point on example23's REMAP posterior (ni = 8,
  seed 0; 16 particles, 50 steps, tests/test_mcmc.py's budget) from the
  same seeded start within 1e-9, its traces too, and the same progress
  lines.  The entry point's default start jitters the MAP by 1e-3: the
  first steps' bandwidth is then ~6e-7 and the repulsion throws the
  particles apart, which amplifies the packages' last-bit differences
  (1e-15 a step) to ~1e-5 within 50 steps; the comparison takes a jitter
  of 0.3 (ROADMAP queue 3).
- The initial-particle forms of the entry point (scalar, 1-D, 2-D, one
  row) give gpmp_tpu's particles; the temperature schedules and the
  option checks are gpmp_tpu's; the mesh option.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.kernel  # noqa: F401
import gpmp_tpu.num as jgnp
from gpmp_tpu.mcmc import svgd as jsv
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.mcmc import svgd as tsv

TOL = 1e-9
TARGET_MEAN = np.array([1.0, -0.5])
TARGET_COV = np.array([[1.0, 0.6], [0.6, 1.5]])
TARGET_PREC = np.linalg.inv(TARGET_COV)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _gauss(xp):
    def log_target(x):
        d = x - xp.asarray(TARGET_MEAN)
        return -0.5 * d @ xp.asarray(TARGET_PREC) @ d

    return log_target


def _model(gp, gnp):
    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 3, covparam, pairwise)

    return gp.Model(mean, kernel)


@pytest.fixture(scope="module")
def posterior():
    """Example23's data (ni = 8, seed 0) and both packages' REMAP fits (the
    gaussian-logsigma2-and-logrho prior of bench_samplers.py)."""
    config.set_device("cpu")
    torch.set_num_threads(2)
    xi = np.asarray(jgp.misc.designs.ldrandunif(1, 8, [[-1], [1]], seed=0))
    zi = np.asarray(jgp.misc.testfunctions.twobumps(xi))
    sel = "select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior"
    _, ji = getattr(jgp.kernel, sel)(_model(jgp, jgnp), xi, zi, info=True)
    _, ti = getattr(tgp.kernel, sel)(_model(tgp, tgnp), xi, zi, info=True)
    return {"jinfo": ji, "tinfo": ti}


RBF_OPTIONS = ({}, {"bandwidth_scale": 0.7}, {"bandwidth": 0.4}, {"bandwidth_min": 5.0},
               {"bandwidth": 1e-20})


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_rbf_kernel_matrix(n):
    p = np.random.default_rng(n).normal(size=(n, 3))
    for kw in RBF_OPTIONS if n in (7, 16) else RBF_OPTIONS[:1]:
        kj, sj, hj = jax.jit(lambda q: jsv.rbf_kernel_matrix(q, **kw))(jnp.asarray(p))
        kt, st, ht = tsv.rbf_kernel_matrix(_t(p), **kw)
        assert ht.shape == ()
        np.testing.assert_allclose(float(ht), float(hj), rtol=1e-14)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-14, atol=1e-15)
    if n > 1:
        off = np.asarray(sj)[~np.eye(n, dtype=bool)]
        assert float(tsv.rbf_kernel_matrix(_t(p))[2]) == pytest.approx(
            np.median(off) / np.log(n + 1.0), rel=1e-14)
    for bad in ({"bandwidth_scale": 0.0}, {"bandwidth_min": -1.0}):
        with pytest.raises(ValueError):
            tsv.rbf_kernel_matrix(_t(p), **bad)
    with pytest.raises(ValueError, match="shape"):
        tsv.rbf_kernel_matrix(_t(p[0]))


def test_svgd_step_with_box_and_preconditioner():
    p = np.random.default_rng(3).normal(scale=1.5, size=(12, 2))
    kw = dict(step_size=0.2, temperature=2.0, sampling_box=[[-2.0, -2.5], [2.0, 2.5]],
              preconditioner_diag=[0.5, 2.0])
    # a particle outside the box is clipped first: kill one through the
    # criterion instead (NaN -> -inf, dead)
    def lp(xp):
        g = _gauss(xp)
        return lambda x: xp.where(x[0] > 1.9, xp.nan, g(x))

    pj, ij = jax.jit(lambda q: jsv.svgd_step(lp(jnp), q, **kw))(jnp.asarray(p))
    pt, it = tsv.svgd_step(lp(torch), _t(p), **kw)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-12)
    assert int(it["alive_count"]) == int(ij["alive_count"]) < 12
    for key in ("log_prob_values", "bandwidth", "velocity_norm", "temperature"):
        np.testing.assert_allclose(tgnp.to_np(it[key]), np.asarray(ij[key]), rtol=1e-12)
    for bad in ({"step_size": 0.0}, {"temperature": -1.0}):
        with pytest.raises(ValueError):
            tsv.svgd_step(_gauss(torch), _t(p), **{**dict(step_size=0.1), **bad})


def test_svgd_gaussian_whole_run_and_moments():
    """tests/test_mcmc.py's run, both packages from the same start."""
    opts = dict(n_steps=400, step_size=0.35, initial_temperature=3.0,
                final_temperature=1.0, progress=False, verbose=0, seed=0)
    box = [[-3.0, -3.0], [3.0, 3.0]]
    pj, ij = jsv.svgd_sample(_gauss(jnp), n_particles=80, dim=2, init_box=box,
                             options=jsv.SVGDOptions(**opts))
    pt, it = tsv.svgd_sample(_gauss(torch), n_particles=80, dim=2, init_box=box,
                             options=tsv.SVGDOptions(**opts))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=TOL)
    assert it["route"] == "vmap"
    p = pt.numpy()
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p.mean(axis=0), TARGET_MEAN, atol=0.4)
    assert np.isfinite(it["log_prob_final"].numpy()).all()
    assert it["bandwidth_trace"].shape == (400,)


def test_svgd_posterior_entry_point(posterior):
    """sample_from_selection_criterion_svgd on the REMAP posterior from the
    same seeded start: the particles, traces and progress lines."""
    kw = dict(n_particles=16, n_steps=50, seed=0, init_jitter=0.3, log_every=10)
    outs = []
    for gp, info in ((jgp, posterior["jinfo"]), (tgp, posterior["tinfo"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p, inf = gp.mcmc.sample_from_selection_criterion_svgd(info=info, **kw)
        outs.append((np.asarray(tgnp.to_np(p)), inf, buf.getvalue()))
    (pj, ij, oj), (pt, it, ot) = outs
    assert it["route"] == "vmap" and pt.shape == (16, 2)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)
    for key in ("log_prob_trace", "bandwidth_trace", "velocity_norm_trace", "log_prob_final",
                "temperature_trace"):
        np.testing.assert_allclose(tgnp.to_np(it[key]), np.asarray(ij[key]), rtol=TOL, atol=TOL)
    assert ot == oj and ot.count("svgd iter") == 6


@pytest.mark.parametrize("form", ["scalar", "1d", "2d", "row", "random"])
def test_initial_particles_forms(posterior, form):
    mp = np.asarray(posterior["jinfo"]["covparam"])
    box = [list(mp - 1.0), list(mp + 1.0)]
    kw = {"scalar": dict(particles_initial=0.3),
          "1d": dict(particles_initial=mp),
          "2d": dict(particles_initial=np.tile(mp, (5, 1)) + 0.01),
          "row": dict(particles_initial=mp.reshape(1, 2)),
          "random": dict(random_init=True, init_box=box)}[form]
    if form == "scalar":  # a scalar start is for dim == 1: a 1-D criterion
        pj, _ = jgp.mcmc.sample_from_selection_criterion_svgd(
            selection_criterion=lambda p: p[0] ** 2, n_particles=5, n_steps=0, seed=4, **kw)
        pt, _ = tgp.mcmc.sample_from_selection_criterion_svgd(
            selection_criterion=lambda p: p[0] ** 2, n_particles=5, n_steps=0, seed=4, **kw)
        assert pt.shape == (5, 1)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-15)
        return
    n = 5
    pj, _ = jgp.mcmc.sample_from_selection_criterion_svgd(
        info=posterior["jinfo"], n_particles=n, n_steps=0, seed=4, sampling_box=box, **kw)
    pt, it = tgp.mcmc.sample_from_selection_criterion_svgd(
        info=posterior["tinfo"], n_particles=n, n_steps=0, seed=4, sampling_box=box, **kw)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-15)
    assert it["log_prob_trace"].shape == (0, pt.shape[0])


def test_schedules_options_and_mesh():
    for sched in ("linear", "geometric"):
        np.testing.assert_array_equal(tsv._annealed_temperatures(7, 10.0, 1.0, sched),
                                      jsv._annealed_temperatures(7, 10.0, 1.0, sched))
    np.testing.assert_array_equal(tsv._annealed_temperatures(1, 10.0, 2.0, "linear"), [2.0])
    with pytest.raises(ValueError):
        tsv._annealed_temperatures(5, 0.0, 1.0, "linear")
    with pytest.raises(ValueError):
        tsv._annealed_temperatures(5, 2.0, 1.0, "cosine")
    np.testing.assert_array_equal(tsv._resolve_preconditioner([3.0], 2, jitter=1e-12).numpy(),
                                  [3.0, 3.0])
    for bad in ([1.0, 2.0, 3.0], [1.0, -1.0]):
        with pytest.raises(ValueError):
            tsv._resolve_preconditioner(bad, 2, jitter=1e-12)
    with pytest.raises(ValueError):
        tsv.svgd_sample(_gauss(torch), options=tsv.SVGDOptions(n_steps=-1))
    with pytest.raises(ValueError, match="init_box"):
        tsv.svgd_sample(_gauss(torch), options=tsv.SVGDOptions(n_steps=1))
    p, info = tsv.svgd_sample(_gauss(torch), _t(np.zeros((3, 2)) + [[0.0], [0.1], [0.3]]),
                              options=tsv.SVGDOptions(n_steps=4, progress=False,
                                                      store_particles_history=True))
    assert info["particles_history"].shape == (4, 3, 2)
    torch.testing.assert_close(info["particles_history"][-1], p, rtol=0, atol=0)

    from gpmp_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(NotImplementedError, match="10c"):
        tsv.svgd_sample(_gauss(torch), _t(np.zeros((2, 2))),
                        options=tsv.SVGDOptions(n_steps=1, mesh=Mesh("cpu", "particles", size=2)))
