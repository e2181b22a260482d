# tests/test_torch_smc.py
"""The port's SMC and subset simulation (gpmp_tpu_torch.mcmc.smc and
sample_from_selection_criterion_smc) against gpmp_tpu's on the CPU, in f64.

- Replay: the port's draw seams (``ParticlesSet._draw_normals``,
  ``_draw_uniforms``, ``_draw_block``) fed gpmp_tpu's draws, derived here
  from the key gpmp_tpu seeds from the same ``rng.integers(2**31)`` and
  split as gpmp_tpu splits it (``_next_key``, ``split(key, n_sweeps)``,
  ``split(key)`` into the normals' and the uniforms' keys:
  gpmp_tpu/mcmc/smc.py:152-155, 315, 358, 380-388, 413).  The NumPy
  ``rng`` (initial particles, resampling counts) is the same object on
  both sides.  Then, on example23's REMAP posterior (ni = 8, seed 0; the
  box the MAP +- 3 of tests/test_mcmc.py, 300 particles, 5 MH steps), on
  tests/test_checkpoint.py's tempered mixture (ESS and p0 ladders) and on
  tests/test_mcmc.py's subset simulation (both tails): the ladders,
  ``stage_probs`` and ``p_est`` within 1e-9 (relative), the ESS values
  within 1e-9, the particles within 1e-9, the acceptance rates within
  1e-12 (the same accept counts; the block's mean of means is summed in
  another order).  A wider box reaches grams near singularity (cond ~1e15
  at log inverse range -9) where the two packages' criteria differ at
  1e-2 relative: the ladders then part, as two runs of either package
  with another LAPACK would.
- Units against gpmp_tpu: both resampling schemes give the same particles
  from the same rng and weights; ``log_indicator_density``,
  ``compute_p_value``, the ESS and ``reweight``; the scaling bounds raise
  ``ParticlesSetError``.
- Port only: checkpoint and resume (test_checkpoint.py's exact-resume test
  on the port's own generator), get_state/set_state (a gpmp_tpu state is
  refused), the mesh option, and tests/test_mcmc.py's statistical checks
  (mixture moments, the Gaussian tail) with the port's own generator.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.kernel  # noqa: F401
import gpmp_tpu.num as jgnp
from gpmp_tpu.mcmc import smc as jsmc
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.mcmc import smc as tsmc

TOL = 1e-9
TOL_RATE = 1e-12


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _next_key(ps):
    """gpmp_tpu's ParticlesSet._next_key on the key it seeds from the same
    integer (the port's generator's initial seed)."""
    if not hasattr(ps, "_jax_key"):
        ps._jax_key = jax.random.PRNGKey(ps._generator.initial_seed())
    ps._jax_key, sub = jax.random.split(ps._jax_key)
    return sub


def _jax_normals(ps, shape):
    return _t(jax.random.normal(_next_key(ps), shape, dtype=jnp.float64))


def _jax_uniforms(ps, shape):
    return _t(jax.random.uniform(_next_key(ps), shape, dtype=jnp.float64))


def _jax_block(ps, n_sweeps):
    eps, u = [], []
    for key in jax.random.split(_next_key(ps), n_sweeps):
        k_eps, k_u = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(k_eps, (ps.n, ps.dim), dtype=jnp.float64)))
        u.append(np.asarray(jax.random.uniform(k_u, (ps.n,), dtype=jnp.float64)))
    return _t(np.stack(eps)), _t(np.stack(u))


@pytest.fixture
def replay(monkeypatch):
    """The port's ParticlesSet draws gpmp_tpu's numbers."""
    monkeypatch.setattr(tsmc.ParticlesSet, "_draw_normals", _jax_normals)
    monkeypatch.setattr(tsmc.ParticlesSet, "_draw_uniforms", _jax_uniforms)
    monkeypatch.setattr(tsmc.ParticlesSet, "_draw_block", _jax_block)


def _same_runs(sj, st, xj, xt):
    """The two SMC instances' logs and particles agree (docstring)."""
    assert len(sj.log) == len(st.log)
    for a, b in zip(sj.log, st.log):
        assert a["stage"] == b["stage"]
        for key in ("current_logpdf_param", "ess"):
            if a[key] is None:
                assert b[key] is None
            else:
                assert abs(b[key] - a[key]) <= TOL * max(1.0, abs(a[key])), (key, a[key], b[key])
        assert a["current_scaling_param"] == pytest.approx(b["current_scaling_param"], rel=1e-14)
        np.testing.assert_allclose(b["acceptation_rate_sequence"],
                                   a["acceptation_rate_sequence"], rtol=0, atol=TOL_RATE)
    np.testing.assert_allclose(tgnp.to_np(xt), np.asarray(xj), rtol=0, atol=TOL)


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


def _log_mix(xp):
    def log_mix(x):
        x = x.reshape(-1)
        p = 0.3 * xp.exp(-0.5 * x**2 / 0.04) + 0.7 * xp.exp(-0.5 * (x - 3.0) ** 2 / 0.16)
        return xp.log(p + 1e-300)

    return log_mix


# ----------------------------------------------------------------------------
# replays
# ----------------------------------------------------------------------------
def test_smc_posterior_replay(posterior, replay):
    """sample_from_selection_criterion_smc on the REMAP posterior, both
    packages, gpmp_tpu's draws: the same run."""
    ji, ti = posterior["jinfo"], posterior["tinfo"]
    mp = np.asarray(ji["covparam"])
    box = [list(mp - 3.0), list(mp + 3.0)]
    xj, sj = jgp.mcmc.sample_from_selection_criterion_smc(
        info=ji, init_box=box, n_particles=300, mh_steps=5, seed=0)
    xt, st = tgp.mcmc.sample_from_selection_criterion_smc(
        info=ti, init_box=box, n_particles=300, mh_steps=5, seed=0)
    assert st.population_route == "vmap"
    assert isinstance(xt, torch.Tensor) and xt.shape == (300, 2)
    _same_runs(sj, st, xj, xt)
    ladder = [s["current_logpdf_param"] for s in st.log if s["ess"] is not None]
    assert ladder[-1] == 1.0 and len(set(ladder)) > 3


@pytest.mark.parametrize("method,p0", [("ess", None), ("p0", 0.5)])
def test_smc_mixture_replay(replay, method, p0):
    """tests/test_checkpoint.py's tempered mixture (400 particles, 5 MH
    steps, the ESS ladder; and the p0 dichotomy), both packages."""
    box = [[-3.0], [6.0]]
    lj, lt = _log_mix(jnp), _log_mix(torch)
    runs = []
    for mod, lp in ((jsmc, lambda x, b: b * lj(jnp.asarray(x))), (tsmc, lambda x, b: b * lt(x))):
        smc = mod.SMC(box=box, n=400, particles_config=mod.ParticlesSetConfig(
                          resample_scheme="residual", covariance_method="normal"),
                      smc_config=mod.SMCConfig(compute_next_logpdf_param_method=method,
                                               mh_steps=5),
                      rng=np.random.default_rng(7))
        smc.step_with_possible_restart(lp, 0.01, 1.0, 0.6, p0)
        runs.append(smc)
    _same_runs(runs[0], runs[1], runs[0].particles.x, runs[1].particles.x)


@pytest.mark.parametrize("tail", ["upper", "lower"])
def test_subset_simulation_replay(replay, tail):
    """tests/test_mcmc.py's Gaussian tail by subset simulation (500
    particles, 10 MH steps), both tails, both packages."""
    thr = [-np.inf, 1.0, 2.0] if tail == "upper" else [np.inf, -1.0, -2.0]
    out = []
    for gp, xp, asarr in ((jgp, jnp, jnp.asarray), (tgp, torch, tgnp.asarray)):
        out.append(gp.mcmc.run_subset_simulation(
            lambda x, a=asarr: a(x).reshape(-1), thr, [[-6.0], [6.0]],
            lambda x, a=asarr, m=xp: -0.5 * a(x).reshape(-1) ** 2 - 0.5 * np.log(2 * np.pi),
            tail=tail, n_particles=500, mh_steps=10, rng=np.random.default_rng(1)))
    (pj, sj, smj), (pt, st, smt) = out
    assert 1e-4 < pt < 0.5 and len(st) == 2
    assert abs(pt - pj) <= TOL * pj
    np.testing.assert_allclose(st, sj, rtol=TOL)
    _same_runs(smj, smt, smj.particles.x, smt.particles.x)


# ----------------------------------------------------------------------------
# units against gpmp_tpu
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["multinomial", "residual"])
def test_resampling_from_the_same_rng_and_weights(scheme):
    w = np.random.default_rng(4).exponential(size=50) ** 3
    xs = []
    for mod, asarr in ((jsmc, jnp.asarray), (tsmc, tgnp.asarray)):
        ps = mod.ParticlesSet([[-1.0, 0.0], [1.0, 2.0]], n=50,
                              config=mod.ParticlesSetConfig(resample_scheme=scheme),
                              rng=np.random.default_rng(3))
        ps.w_tmp = asarr(w)
        ps.resample()
        xs.append((np.asarray(tgnp.to_np(ps.x)), float(tgnp.to_np(ps.w)[0])))
    np.testing.assert_array_equal(xs[1][0], xs[0][0])
    assert xs[1][1] == xs[0][1] == 1.0 / 50


def test_reweight_ess_indicator_and_p_value():
    box = [[-2.0], [2.0]]
    lj = jsmc.log_indicator_density(lambda x: jnp.asarray(x).reshape(-1) ** 2, 1.0,
                                    lambda x: -jnp.asarray(x).reshape(-1) ** 2, tail="lower")
    lt = tsmc.log_indicator_density(lambda x: x.reshape(-1) ** 2, 1.0,
                                    lambda x: -x.reshape(-1) ** 2, tail="lower")
    sj = jsmc.SMC(box, n=64, rng=np.random.default_rng(5))
    st = tsmc.SMC(box, n=64, rng=np.random.default_rng(5))
    for smc, lp in ((sj, lj), (st, lt)):
        smc.particles.set_logpdf(lp)
        smc.particles.reweight()
    np.testing.assert_array_equal(tgnp.to_np(st.particles.logpx), np.asarray(sj.particles.logpx))
    np.testing.assert_allclose(tgnp.to_np(st.particles.w), np.asarray(sj.particles.w), rtol=1e-15)
    assert st.particles.ess() == pytest.approx(sj.particles.ess(), rel=1e-14)
    with pytest.raises(ValueError, match="tail"):
        tsmc.log_indicator_density(lambda x: x, 0.0, lambda x: x, tail="both")(tgnp.zeros((2, 1)))
    pj = sj.compute_p_value(lambda x, b: b * jnp.sin(jnp.asarray(x)).reshape(-1), 0.7, 0.2)
    pt = st.compute_p_value(lambda x, b: b * torch.sin(x).reshape(-1), 0.7, 0.2)
    assert pt == pytest.approx(pj, rel=1e-14)


def test_scaling_bounds_raise():
    ps = tsmc.ParticlesSet([[-1.0], [1.0]], n=10, rng=np.random.default_rng(0))
    ps.param_s = 1e-4
    with pytest.raises(tsmc.ParticlesSetError):
        ps.perturb()
    ps.param_s = 1e6
    with pytest.raises(tsmc.ParticlesSetError):
        ps.move_block(3)


# ----------------------------------------------------------------------------
# port only: checkpoint, state, mesh, statistics
# ----------------------------------------------------------------------------
def test_smc_resume_is_exact(tmp_path):
    """tests/test_checkpoint.py's test on the port: the ladder interrupted at
    a stage boundary and resumed from its checkpoint reproduces the
    uninterrupted run exactly (the generator's state is in the checkpoint)."""
    lt = _log_mix(torch)

    def logpdf_temp(x, beta):
        return beta * lt(x)

    box = [[-3.0], [6.0]]
    pc = tsmc.ParticlesSetConfig(resample_scheme="residual", covariance_method="normal")

    def make(checkpoint=None):
        sc = tsmc.SMCConfig(compute_next_logpdf_param_method="ess", mh_steps=5,
                            checkpoint_path=checkpoint, checkpoint_every=1)
        return tsmc.SMC(box=box, n=400, particles_config=pc, smc_config=sc,
                        rng=np.random.default_rng(7))

    smc_ref = make()
    smc_ref.step_with_possible_restart(logpdf_temp, 0.01, 1.0, 0.6, None)
    x_ref = smc_ref.particles.x.numpy()

    stashed = []
    smc_a = make(checkpoint=str(tmp_path / "smc.npz"))
    orig = smc_a.save_checkpoint

    def stash(path):
        p = tmp_path / f"smc_{len(stashed)}.npz"
        orig(str(p))
        stashed.append(p)

    smc_a.save_checkpoint = stash
    smc_a.step_with_possible_restart(logpdf_temp, 0.01, 1.0, 0.6, None)
    np.testing.assert_array_equal(smc_a.particles.x.numpy(), x_ref)
    assert len(stashed) >= 2

    mid = stashed[len(stashed) // 2 - 1]
    smc_b = make()
    smc_b.restore_checkpoint(str(mid))
    assert smc_b._ladder_state is not None
    assert smc_b._ladder_state["current_logpdf_param"] < 1.0
    smc_b.resume_restart(logpdf_temp)
    np.testing.assert_array_equal(smc_b.particles.x.numpy(), x_ref)
    with pytest.raises(ValueError, match="nothing to resume"):
        make().resume_restart(logpdf_temp)


def test_state_round_trip_and_refusals(tmp_path):
    box = [[-3.0], [6.0]]
    a = tsmc.SMC(box, n=20, rng=np.random.default_rng(1))
    arrays, meta = a.get_state()
    assert set(arrays) == {"x", "logpx", "w", "generator_state"}
    b = tsmc.SMC(box, n=20, rng=np.random.default_rng(2))
    b.set_state(arrays, meta)
    np.testing.assert_array_equal(b.particles.x.numpy(), a.particles.x.numpy())
    assert torch.equal(b.particles._draw_normals((3, 1)), a.particles._draw_normals((3, 1)))
    with pytest.raises(ValueError, match="generator_state"):
        b.set_state({k: v for k, v in arrays.items() if k != "generator_state"}, meta)
    with pytest.raises(ValueError, match="shape mismatch"):
        tsmc.SMC(box, n=21, rng=np.random.default_rng(2)).set_state(arrays, meta)
    with pytest.raises(ValueError, match="Not an SMC"):
        b.set_state(arrays, dict(meta, kind="MetropolisHastings"))
    path = tmp_path / "jax.npz"
    jsmc.SMC(box, n=20, rng=np.random.default_rng(1)).save_checkpoint(str(path))
    with pytest.raises(ValueError, match="gpmp_tpu"):
        b.restore_checkpoint(str(path))
    assert os.path.exists(path)


def test_mesh_option():
    from gpmp_tpu_torch.parallel import make_mesh
    from gpmp_tpu_torch.parallel.mesh import Mesh

    tsmc.ParticlesSet([[0.0], [1.0]], n=8, config=tsmc.ParticlesSetConfig(mesh=make_mesh(1)))
    with pytest.raises(NotImplementedError, match="10c"):
        tsmc.ParticlesSet([[0.0], [1.0]], n=8,
                          config=tsmc.ParticlesSetConfig(mesh=Mesh("cpu", "particles", size=2)))


def test_smc_tempered_gaussian_mixture():
    """tests/test_mcmc.py's mixture check on the port's own generator."""
    m1, s1, w1 = 0.0, 0.2, 0.3
    m2, s2, w2 = 3.0, 0.4, 0.7

    def logpdf_temp(x, beta):
        x = x.reshape(-1)
        p = (w1 * torch.exp(-0.5 * (x - m1) ** 2 / s1**2) / s1
             + w2 * torch.exp(-0.5 * (x - m2) ** 2 / s2**2) / s2)
        return beta * torch.log(p + 1e-300)

    particles, smc = tgp.mcmc.run_smc_sampling(
        logpdf_parameterized_function=logpdf_temp, initial_logpdf_param=0.01,
        target_logpdf_param=1.0, compute_next_logpdf_param_method="ess", min_ess_ratio=0.6,
        init_box=[[-3.0], [6.0]], n_particles=800, mh_steps=10, rng=np.random.default_rng(0))
    x = particles.numpy().reshape(-1)
    assert abs(x.mean() - (w1 * m1 + w2 * m2)) < 0.35
    assert (x < 1.0).mean() > 0.1
    assert (x > 2.0).mean() > 0.4


def test_subset_simulation_gaussian_tail():
    """tests/test_mcmc.py's tail check on the port's own generator."""
    p_est, stage_probs, _smc = tgp.mcmc.run_subset_simulation(
        lambda x: x.reshape(-1), [-np.inf, 1.0, 2.0], [[-6.0], [6.0]],
        lambda x: -0.5 * x.reshape(-1) ** 2 - 0.5 * np.log(2 * np.pi), tail="upper",
        n_particles=1500, mh_steps=10, rng=np.random.default_rng(1))
    assert 0.0 < p_est < 1.0 and len(stage_probs) == 2
    assert 1e-4 < p_est < 0.5
    with pytest.raises(AssertionError):
        tgp.mcmc.run_subset_simulation(lambda x: x, [0.0, 1.0], [[-1.0], [1.0]],
                                       lambda x: x, tail="upper")
