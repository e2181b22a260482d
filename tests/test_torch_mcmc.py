# tests/test_torch_mcmc.py
"""The port's MH and NUTS samplers (gpmp_tpu_torch.mcmc) against gpmp_tpu's
on the CPU, in f64.

- MH replay: gpmp_tpu's block kernel (``_get_block_kernel()``, jitted) on
  keys ``jax.random.split(PRNGKey(s), n)``, and the port's block step fed the
  same proposal normals and uniforms, derived here from those keys as the
  kernel derives them (gpmp_tpu/mcmc/mh.py:293-304), for 3 seeds, on a 3-D
  Gaussian and on example23's REMAP posterior (its state carried from a
  gpmp_tpu run through ``interop.mh_state_from_numpy``): the chains within
  1e-12, the acceptance flags identical.
- NUTS replay: gpmp_tpu's transition (jitted) against the port's fed the
  draws of the same key splits (momentum, slice, each doubling's direction
  and adopt draw, each leaf's adopt draw), for 3 seeds at two step sizes,
  on the Gaussian and on the posterior: q_new within 1e-12, n_leapfrog,
  depth and divergent identical; accept_stat within 1e-12 on the Gaussian.
  On the posterior accept_stat is held to 1e-11: it averages exp(-(H1 -
  H0)) over the leaves, and the two packages' REMAP criteria agree to
  ~1e-11 relative at these points (~5e-12 absolute in H; gpmp_tpu's own
  two criteria differ by up to 2.4e-12: test_remap_criteria_probe), which shows in
  accept_stat at ~5e-12.  Every draw is replayed.
- The deterministic pieces at 1e-12 (exactly where the arithmetic is the
  same): leapfrog, is_uturn, kinetic, find_reasonable_step_size from the
  same momentum, DualAveragingState, RunningDiagVar, make_warmup_windows,
  _make_log_prob (values and gradients: inside, outside the box, and where
  the criterion is NaN), _normalize_initial_states, _normalize_bounds,
  get_log_target_values, Gelman-Rubin, the sliding rates and ks_statistics
  on the same chains, estimate_cov_matrix(_knn) with the same rng, and the
  Haario and RM proposal updates from the same blocks.
- Whole runs, port only, on tests/test_mcmc.py's Gaussian and banana
  targets and budgets, with that file's moment tolerances.
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
from gpmp_tpu.mcmc import knn_cov as jknn
from gpmp_tpu.mcmc import mh as jmh
from gpmp_tpu.mcmc import nuts as jnuts
from gpmp_tpu.mcmc import param_posterior as jpp
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config, interop
from gpmp_tpu_torch.mcmc import knn_cov as tknn
from gpmp_tpu_torch.mcmc import mh as tmh
from gpmp_tpu_torch.mcmc import nuts as tnuts
from gpmp_tpu_torch.mcmc import param_posterior as tpp

TOL = 1e-12
TOL_POSTERIOR_ACCEPT = 1e-11  # the criteria's agreement floor (docstring)
SEEDS = (0, 1, 2)
N_REPLAY = 50  # MH steps per replayed block

TARGET_MEAN = np.array([1.0, -0.5])
TARGET_COV = np.array([[1.0, 0.6], [0.6, 1.5]])
TARGET_PREC = np.linalg.inv(TARGET_COV)

G3_MEAN = np.array([0.5, -1.0, 2.0])
G3_COV = np.array([[1.0, 0.3, -0.2], [0.3, 0.5, 0.1], [-0.2, 0.1, 2.0]])
G3_PREC = np.linalg.inv(G3_COV)


@pytest.fixture(autouse=True, scope="module")
def _module_on_the_cpu():
    """The module's references are built on the CPU too."""
    config.set_device("cpu")
    torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _gauss(xp, mean, prec):
    def log_target(x):
        d = x - xp.asarray(mean)
        return -0.5 * d @ xp.asarray(prec) @ d

    return log_target


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _model(gp, gnp):
    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 3, covparam, pairwise)

    return gp.Model(mean, kernel)


def _example23_data(ni=10, seed=0):
    xi = np.asarray(jgp.misc.designs.ldrandunif(1, ni, [[-1], [1]], seed=seed))
    return xi, np.asarray(jgp.misc.testfunctions.twobumps(xi))


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


class _JaxNutsDraws:
    """The port's NUTS draw source replaying gpmp_tpu's key splits for one
    transition (gpmp_tpu/mcmc/nuts.py:353, :401, :498)."""

    def __init__(self, key, dim):
        k_mom, k_slice, self.k_loop = jax.random.split(key, 3)
        self.momentum = np.asarray(jax.random.normal(k_mom, (dim,), dtype=jnp.float64))
        self.slice = float(jax.random.uniform(k_slice, dtype=jnp.float64))
        self.k_sub = self.k_adopt = None

    def __call__(self, kind):
        if kind == "momentum":
            return torch.from_numpy(self.momentum.copy())
        if kind == "slice":
            return self.slice
        if kind == "direction":
            self.k_loop, k_dir, self.k_sub, self.k_adopt = jax.random.split(self.k_loop, 4)
            return float(jax.random.uniform(k_dir, dtype=jnp.float64))
        if kind == "leaf":
            self.k_sub, k = jax.random.split(self.k_sub)
            return float(jax.random.uniform(k, dtype=jnp.float64))
        assert kind == "adopt", kind
        return float(jax.random.uniform(self.k_adopt, dtype=jnp.float64))


def _mh_draws(keys, n_chains, dim):
    """The proposal normals (n, C, d) and uniforms (n, C) gpmp_tpu's block
    kernel derives from its per-step keys."""
    eps, u = [], []
    for key in keys:
        k_prop, k_u = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(k_prop, (n_chains, dim), dtype=jnp.float64)))
        u.append(np.maximum(np.asarray(jax.random.uniform(k_u, (n_chains,),
                                                          dtype=jnp.float64)), 1e-300))
    return _t(np.stack(eps)), _t(np.stack(u))


# ----------------------------------------------------------------------------
# the JAX references, computed once
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def posterior():
    """Example23's data, both packages' REMAP fits and log targets, and a
    gpmp_tpu MH run on it (its state is carried to the port)."""
    xi, zi = _example23_data()
    _, ji = jgp.kernel.select_parameters_with_remap(_model(jgp, jgnp), xi, zi, info=True)
    _, ti = tgp.kernel.select_parameters_with_remap(_model(tgp, tgnp), xi, zi, info=True)
    out = {"xi": xi, "zi": zi, "jinfo": ji, "tinfo": ti}
    for grad in (False, True):
        out[("j", grad)] = jpp._make_log_prob(
            jpp._resolve_selection_criterion(ji, None, require_differentiable=grad), None, None)
        out[("t", grad)] = tpp._make_log_prob(
            tpp._resolve_selection_criterion(ti, None, require_differentiable=grad), None, None)
    # gpmp_tpu's log target compiled once: the tests differentiate it
    # eagerly, which compiles its forward and backward once for them all
    out["j jit"] = jax.jit(out[("j", True)])
    _samples, mh = jpp.sample_from_selection_criterion_mh(
        info=ji, n_steps_total=400, burnin_period=200, n_chains=2, silent=True,
        plot_chains=False, plot_empirical_distributions=False, seed=3)
    out["jmh"] = mh
    out["jmh_state"] = mh.get_state()
    return out


def _carried_port_mh(jmh_obj, log_target, seed=0):
    arrays, meta = jmh_obj.get_state()
    mh = tmh.MetropolisHastings(log_target, options=tmh.MHOptions(
        dim=meta["dim"], n_chains=meta["n_chains"], init_msg=None,
        n_pool=jmh_obj.options.n_pool, adaptation_method=jmh_obj.options.adaptation_method,
        target_acceptance=jmh_obj.options.target_acceptance))
    return interop.mh_state_from_numpy(mh, {k: np.asarray(v) for k, v in arrays.items()},
                                       meta, seed=seed)


def _jax_block(jmh_obj, x0, lt0, chols, seed, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    xs, acc, lts = jax.device_get(jmh_obj._get_block_kernel()(
        jnp.asarray(x0), jnp.asarray(lt0), jnp.asarray(chols), keys)[2:])
    return keys, np.asarray(xs), np.asarray(acc), np.asarray(lts)


def test_remap_criteria_probe(posterior):
    """Step 0's probe: example23's REMAP criteria from ``info`` (the
    differentiable one NUTS reads, the no-grad one MH reads) and the
    gradient, port against gpmp_tpu, at the MAP and 8 points around it
    (radius 0.5).  Measured: values within 8.3e-12 relative (gpmp_tpu's own
    two criteria differ by up to 2.4e-12 there), gradients within 5.1e-12
    relative off the MAP (at the MAP the gradient is ~0: 1e-7 of its
    size)."""
    ji, ti = posterior["jinfo"], posterior["tinfo"]
    pm = np.asarray(ji["covparam"])
    np.testing.assert_allclose(tgnp.to_np(ti["covparam"]), pm, atol=1e-7)
    worst = {"value": 0.0, "jax own": 0.0, "grad": 0.0}
    for k, p in enumerate([pm] + [pm + 0.5 * np.array([np.cos(a), np.sin(a)])
                                  for a in np.arange(8) * np.pi / 4]):
        for key in ("selection_criterion", "selection_criterion_nograd"):
            vj, vt = ji[key](p), ti[key](p)
            worst["value"] = max(worst["value"], abs(vt - vj) / abs(vj))
        vj, vjn = ji["selection_criterion"](p), ji["selection_criterion_nograd"](p)
        worst["jax own"] = max(worst["jax own"], abs(vj - vjn) / abs(vj))
        if k > 0:
            gj = np.asarray(ji["selection_criterion"].__self__.gradient(p))
            gt = ti["selection_criterion"].__self__.gradient(p)
            worst["grad"] = max(worst["grad"],
                                float(np.max(np.abs(gt - gj)) / np.max(np.abs(gj))))
    print("REMAP criteria, port vs gpmp_tpu, worst relative:", worst)
    assert worst["value"] <= 1e-11 and worst["grad"] <= 1e-11


# ----------------------------------------------------------------------------
# MH replay
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mh_gauss_ref():
    C, d = 2, 3
    jm = jmh.MetropolisHastings(_gauss(jnp, G3_MEAN, G3_PREC), options=jmh.MHOptions(
        dim=d, n_chains=C, init_msg=None, seed=0))
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(C, d))
    lt0 = np.array([float(_gauss(np, G3_MEAN, G3_PREC)(x)) for x in x0])
    chols = np.stack([np.linalg.cholesky(0.6 * G3_COV), np.linalg.cholesky(0.3 * np.eye(d))])
    return jm, x0, lt0, chols, {s: _jax_block(jm, x0, lt0, chols, s, N_REPLAY) for s in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_mh_replay_gaussian(mh_gauss_ref, seed):
    jm, x0, lt0, chols, refs = mh_gauss_ref
    keys, xs_j, acc_j, lts_j = refs[seed]
    tm = tmh.MetropolisHastings(_gauss(torch, _t(G3_MEAN), _t(G3_PREC)),
                                options=tmh.MHOptions(dim=3, n_chains=2, init_msg=None))
    eps, u = _mh_draws(keys, 2, 3)
    xs, acc, lts = tmh._mh_block(tm._batched_target, _t(x0), _t(lt0), _t(chols), eps, u)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    assert 0 < acc_j.mean() < 1
    np.testing.assert_allclose(xs.numpy(), xs_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(lts.numpy(), lts_j, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def mh_posterior_ref(posterior):
    jm = posterior["jmh"]
    i = jm.global_iter
    x0 = jm.x[:, i, :].copy()
    lt0 = jm.log_target_values[:, i].copy()
    chols = np.asarray(jm._proposal_chols())
    return x0, lt0, chols, {s: _jax_block(jm, x0, lt0, chols, s, N_REPLAY) for s in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_mh_replay_posterior(posterior, mh_posterior_ref, seed):
    """The chains carried from gpmp_tpu's run (interop), then one block of
    both packages on the same draws."""
    x0, lt0, chols, refs = mh_posterior_ref
    keys, xs_j, acc_j, lts_j = refs[seed]
    tm = _carried_port_mh(posterior["jmh"], posterior[("t", False)], seed=seed)
    i = tm.global_iter
    np.testing.assert_array_equal(tm.x[:, i, :], x0)
    np.testing.assert_array_equal(tm.log_target_values[:, i], lt0)
    np.testing.assert_allclose(tm._proposal_chols(), chols, rtol=0, atol=TOL)
    eps, u = _mh_draws(keys, 2, 2)
    xs, acc, lts = tmh._mh_block(tm._batched_target, _t(x0), _t(lt0),
                                 _t(tm._proposal_chols()), eps, u)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    assert 0 < acc_j.mean() < 1
    np.testing.assert_allclose(xs.numpy(), xs_j, rtol=0, atol=TOL)
    # the log-target values: the criteria's agreement (~1e-12 relative)
    np.testing.assert_allclose(lts.numpy(), lts_j, rtol=1e-10)


# ----------------------------------------------------------------------------
# NUTS replay
# ----------------------------------------------------------------------------
NUTS_CASES = {
    # target: (q0 offsets from its centre, inverse mass, step sizes, max_depth)
    "gaussian": (np.array([[0.3, -0.4], [1.5, 0.2], [-1.0, -1.2]]), np.array([1.0, 0.7]),
                 (0.1, 0.6), 8),
    "posterior": (np.array([[0.1, -0.05], [0.2, -0.1], [-0.15, 0.1]]), np.array([1.0, 1.0]),
                  (0.02, 0.05), 8),
}


@pytest.fixture(scope="module")
def nuts_refs(posterior):
    out = {}
    for target, (offsets, imd, steps, depth) in NUTS_CASES.items():
        if target == "gaussian":
            lpj, lpt = _gauss(jnp, TARGET_MEAN, TARGET_PREC), _gauss(torch, _t(TARGET_MEAN),
                                                                     _t(TARGET_PREC))
            centre = TARGET_MEAN
        else:
            lpj, lpt = posterior[("j", True)], posterior[("t", True)]
            centre = np.asarray(posterior["jinfo"]["covparam"])
        trans = jax.jit(jnuts._make_transition(lpj, depth))
        for s, off in zip(SEEDS, offsets):
            for eps in steps:
                key = jax.random.PRNGKey(s)
                q0 = centre + off
                res = trans(key, jnp.asarray(q0), jnp.asarray(eps), jnp.asarray(imd),
                            jnp.asarray(1000.0))
                out[(target, s, eps)] = (key, q0, jax.device_get(res))
        out[target] = (lpt, imd, depth)
    return out


@pytest.mark.parametrize("target", sorted(NUTS_CASES))
@pytest.mark.parametrize("seed", SEEDS)
def test_nuts_replay(nuts_refs, target, seed):
    lpt, imd, depth = nuts_refs[target]
    trans = tnuts._make_transition(lpt, depth)
    leapfrogs = 0
    for eps in NUTS_CASES[target][2]:
        key, q0, (qj, aj, nj, dj, vj) = nuts_refs[(target, seed, eps)]
        qt, at, nt, dt, vt, Ut = trans(_JaxNutsDraws(key, 2), _t(q0), eps, _t(imd), 1000.0)
        assert (nt, dt, vt) == (int(nj), int(dj), bool(vj))
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=TOL)
        tol_a = TOL if target == "gaussian" else TOL_POSTERIOR_ACCEPT
        assert abs(at - float(aj)) <= tol_a
        # the potential tracked with the proposal is the log-probability there
        assert abs(-float(Ut) - float(lpt(qt))) <= TOL * max(1.0, abs(float(Ut)))
        leapfrogs += nt
    assert leapfrogs > 2


def test_nuts_transition_public_wrapper():
    """nuts_transition takes a torch.Generator; one generator gives one
    trajectory."""
    lp = _gauss(torch, _t(TARGET_MEAN), _t(TARGET_PREC))
    outs = [tnuts.nuts_transition(lp, np.zeros(2), 0.3, np.ones(2), 6, 1000.0,
                                  generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1:] == outs[1][1:]
    q, a, nlf, depth, div = outs[0]
    assert q.shape == (2,) and 0.0 <= a <= 1.0 and nlf >= 1 and depth >= 1 and not div


# ----------------------------------------------------------------------------
# the deterministic pieces
# ----------------------------------------------------------------------------
def test_leapfrog_kinetic_uturn(posterior):
    rng = np.random.default_rng(0)
    imd = np.array([1.3, 0.6])
    for lpj, lpt, q in (
        (jax.jit(_gauss(jnp, TARGET_MEAN, TARGET_PREC)),
         _gauss(torch, _t(TARGET_MEAN), _t(TARGET_PREC)), rng.normal(size=2)),
        (posterior["j jit"], posterior[("t", True)],
         np.asarray(posterior["jinfo"]["covparam"]) + [0.05, -0.03]),
    ):
        p = rng.normal(size=2)
        Uj, gj = jnuts.potential_and_grad(lpj, jnp.asarray(q))
        Ut, gt = tnuts.potential_and_grad(lpt, _t(q))
        assert abs(float(Ut) - float(Uj)) <= 1e-10 * max(1.0, abs(float(Uj)))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(tnuts.kinetic(_t(p), _t(imd))),
                                   float(jnuts.kinetic(jnp.asarray(p), jnp.asarray(imd))),
                                   rtol=TOL)
        res_j = jnuts.leapfrog(lpj, jnp.asarray(q), jnp.asarray(p), gj, jnp.asarray(0.07),
                               jnp.asarray(imd))
        res_t = tnuts.leapfrog(lpt, _t(q), _t(p), _t(np.asarray(gj)), 0.07, _t(imd))
        for a, b in zip(res_t, res_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=TOL)
        for _ in range(20):
            qm, qp, pm, pp_ = rng.normal(size=(4, 2))
            args = (qm, qp, pm, pp_, imd)
            assert bool(tnuts.is_uturn(*map(_t, args))) == bool(
                jnuts.is_uturn(*map(jnp.asarray, args)))


@pytest.mark.parametrize("init_eps", [1.0, 1e-3, 50.0])
def test_find_reasonable_step_size(posterior, init_eps):
    """From the same momentum (gpmp_tpu draws it from its key; the port takes
    it as given) the same step size, the first one past the target."""
    q = np.asarray(posterior["jinfo"]["covparam"])
    imd = np.array([1.0, 2.0])
    key = jax.random.PRNGKey(7)
    eps_j = jnuts.find_reasonable_step_size(posterior["j jit"], jnp.asarray(q),
                                            jnp.asarray(imd), init_eps=init_eps, key=key)
    p0 = np.asarray(jax.random.normal(key, (2,), dtype=jnp.float64)) * np.sqrt(1.0 / imd)
    eps_t = tnuts._find_reasonable_step_size_from(posterior[("t", True)], _t(q), _t(imd),
                                                  _t(p0), init_eps=init_eps)
    assert eps_t == eps_j
    # the public form draws its momentum from a generator
    g = torch.Generator().manual_seed(1)
    e1 = tnuts.find_reasonable_step_size(posterior[("t", True)], _t(q), _t(imd), generator=g)
    assert e1 > 0 and np.isfinite(e1)


def test_dual_averaging_and_welford():
    rng = np.random.default_rng(1)
    da_j = jnuts.DualAveragingState(mu=np.log(2.0), log_eps=0.0, log_eps_bar=0.0, h_bar=0.0, t=0)
    da_t = tnuts.DualAveragingState(mu=np.log(2.0), log_eps=0.0, log_eps_bar=0.0, h_bar=0.0, t=0)
    for a in rng.uniform(size=40):
        assert da_t.update(a, target=0.7) == da_j.update(a, target=0.7)
    assert da_t.final() == da_j.final()
    rv_j, rv_t = jnuts.RunningDiagVar(3), tnuts.RunningDiagVar(3)
    assert np.array_equal(rv_t.var(), rv_j.var())
    for _ in range(5):
        x = rng.normal(size=(4, 3))
        rv_j.update_batch(x)
        rv_t.update_batch(x)
    np.testing.assert_array_equal(rv_t.var(), rv_j.var())
    np.testing.assert_array_equal(rv_t.mean, rv_j.mean)


def test_make_warmup_windows():
    kw = dict(min_no_window=10, large_threshold=100, large_init_buffer=20,
              large_term_buffer=15, large_base_window=10)
    for n in (0, 5, 20, 21, 60, 149, 150, 300, 1000, 1234):
        w = tnuts.make_warmup_windows(n)
        assert w == jnuts.make_warmup_windows(n)
        assert tnuts.describe_windows(w) == jnuts.describe_windows(w)
        assert tnuts.make_warmup_windows(n, **kw) == jnuts.make_warmup_windows(n, **kw)


def _chol_criterion(xp, chol):
    """J(p) = sum log diag chol([[1, p0], [p0, 1 + p1^2]]) + |p|^2 / 2: NaN
    where |p0| > sqrt(1 + p1^2) (the factor fails), as a gram's would."""
    def crit(p):
        A = xp.stack([xp.stack([xp.ones_like(p[0]), p[0]]),
                      xp.stack([p[0], 1.0 + p[1] ** 2])])
        return xp.sum(xp.log(xp.diagonal(chol(A)))) + 0.5 * xp.sum(p * p)

    return crit


def test_make_log_prob_values_and_gradients(posterior):
    """The values and jax.grad's gradients at the same points: the REMAP
    posterior inside the box, outside it and where its criterion is +inf
    (log sigma2 = 800); a criterion whose Cholesky fails (NaN values: the
    log target -inf) inside the box.  Where the log target is finite the
    gradients agree and are finite; where the criterion is NaN, jax.grad
    gives NaN and the port 0 (stated below)."""
    lower, upper = [-2.0, -3.0], [3.0, 4.0]
    crits = {
        "remap": (jpp._resolve_selection_criterion(posterior["jinfo"], None,
                                                   require_differentiable=True),
                  tpp._resolve_selection_criterion(posterior["tinfo"], None,
                                                   require_differentiable=True),
                  ([0.5, 0.3], [1.0, -0.2], [3.5, 0.3], [800.0, 0.3])),
        "chol": (_chol_criterion(jnp, jnp.linalg.cholesky), _chol_criterion(torch, tgnp.cholesky),
                 ([0.5, 0.3], [2.5, 0.3], [-1.9, 1.5], [2.9, 3.9])),
    }
    lb_j, ub_j, lo_np, up_np = jpp._normalize_bounds([lower, upper], 2)
    lb_t, ub_t, lo_t, up_t = tpp._normalize_bounds([lower, upper], 2)
    np.testing.assert_array_equal(lo_t, lo_np)
    np.testing.assert_array_equal(up_t, up_np)
    kinds = set()
    for crit_j, crit_t, points in crits.values():
        for temperature, box in ((1.0, False), (2.5, True)):
            if True:
                lp_j = jpp._make_log_prob(crit_j, *((lb_j, ub_j) if box else (None, None)),
                                          temperature)
                lp_t = tpp._make_log_prob(crit_t, *((lb_t, ub_t) if box else (None, None)),
                                          temperature)
                vg_j = (jax.value_and_grad(posterior["j jit"])
                        if crit_j is crits["remap"][0] and not box
                        else jax.jit(jax.value_and_grad(lp_j)))
                for p in points:
                    vj, gj = vg_j(jnp.asarray(p))
                    vj, gj = float(vj), np.asarray(gj)
                    pt = _t(p).requires_grad_(True)
                    vt_t = lp_t(pt)
                    (gt,) = torch.autograd.grad(vt_t, pt)
                    vt = float(vt_t.detach())
                    if np.isfinite(vj):
                        assert abs(vt - vj) <= 1e-10 * max(1.0, abs(vj))
                        assert np.all(np.isfinite(gt.numpy()))
                        kinds.add("finite")
                    else:
                        assert vt == vj == -np.inf
                        if np.isnan(float(crit_j(jnp.asarray(p)))):
                            # jax.grad: NaN (0 * NaN in its Cholesky's
                            # backward); the port: 0 (cholesky_ex's masked
                            # factor takes a zero cotangent).  U = +inf marks
                            # such a leaf bad either way: no trajectory reads it
                            assert np.all(np.isnan(gj)) and np.all(gt.numpy() == 0.0)
                            kinds.add("nan")
                            continue
                        kinds.add("-inf")
                    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-8, atol=1e-10)
    assert kinds == {"finite", "nan", "-inf"}
    with pytest.raises(ValueError):
        tpp._make_log_prob(crits["chol"][1], None, None, temperature=0.0)


def test_non_pd_gram_maps_to_minus_inf(posterior):
    """A covariance that fails its Cholesky: the factor is NaN (cholesky_ex,
    nothing raises), the REML +inf (its NaN mapped, as in gpmp_tpu), the log
    target -inf, and the MH proposal rejected; far in the REMAP posterior's tails the criterion is +inf
    (log sigma2 = 800) or huge and finite (log inverse range -1000: the
    gram's diagonal keeps it positive definite), never an exception."""
    def bad_kernel(x, y, covparam, pairwise=False):
        return -tgnp.exp(covparam[0]) * tgnp.eye(x.shape[0])

    model = tgp.Model(lambda x, p: tgnp.ones((x.shape[0], 1)), bad_kernel)
    xi, zi = posterior["xi"], posterior["zi"]
    crit = lambda p: model.negative_log_restricted_likelihood(p, tgnp.asarray(xi),
                                                              tgnp.asarray(zi))
    assert torch.isnan(tgnp.cholesky(bad_kernel(tgnp.asarray(xi), None, _t([0.0])))).all()
    assert float(crit(_t([0.0, 0.0]))) == np.inf
    lp = tpp._make_log_prob(crit, None, None)
    assert float(lp(_t([0.0, 0.0]))) == -np.inf
    mh = tmh.MetropolisHastings(lp, options=tmh.MHOptions(dim=2, n_chains=2, init_msg=None))
    assert torch.all(mh._batched_target(torch.zeros((2, 2), dtype=torch.float64)) == -np.inf)
    crit_t = tpp._resolve_selection_criterion(posterior["tinfo"], None,
                                              require_differentiable=False)
    lp_t = tpp._make_log_prob(crit_t, None, None)
    assert float(lp_t(_t([800.0, 0.3]))) == -np.inf
    assert np.isfinite(float(lp_t(_t([0.0, -1000.0]))))


def test_normalize_initial_states_and_dims(posterior):
    info_j, info_t = posterior["jinfo"], posterior["tinfo"]
    np.testing.assert_allclose(
        tpp._normalize_initial_states(info_t, None, 3, 2).numpy(),
        np.asarray(jpp._normalize_initial_states(info_j, None, 3, 2)), atol=1e-7)
    cases = [(np.array(0.5), 3, 1), (np.array([0.1, 0.2]), 3, 2), (np.array([0.1, 0.2, 0.3]), 3, 1),
             (np.ones((3, 2)), 3, 2), (np.ones((1, 2)), 3, 2), (np.arange(6.0).reshape(2, 3), 3, 2)]
    for theta, n_chains, dim in cases:
        a = tpp._normalize_initial_states(None, theta, n_chains, dim).numpy()
        b = np.asarray(jpp._normalize_initial_states(None, jnp.asarray(theta), n_chains, dim))
        np.testing.assert_array_equal(a, b)
        assert tpp._infer_dim(None, theta, None) == jpp._infer_dim(None, jnp.asarray(theta), None)
    for theta, n_chains, dim in ((np.ones(4), 3, 2), (np.ones((2, 5)), 3, 2), (np.ones(3), 3, 2)):
        with pytest.raises(ValueError):
            tpp._normalize_initial_states(None, theta, n_chains, dim)
        with pytest.raises(ValueError):
            jpp._normalize_initial_states(None, jnp.asarray(theta), n_chains, dim)
    assert tpp._infer_dim(info_t, None, None) == jpp._infer_dim(info_j, None, None) == 2
    assert tpp._infer_dim(None, None, [[0, 0, 0], [1, 1, 1]]) == 3
    for box in ([0.0, 1.0], [[0.0], [1.0]], [[-1, -2], [1, 2]]):
        lt_, ut_, a, b = tpp._normalize_bounds(box, 2)
        _, _, c, d = jpp._normalize_bounds(box, 2)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        np.testing.assert_array_equal(lt_.numpy(), c)
    with pytest.raises(ValueError):
        tpp._normalize_bounds([[0, 0, 0], [1, 1, 1]], 2)
    np.testing.assert_array_equal(
        tpp._random_initial_states(np.zeros(2), np.ones(2), 2, 4, seed=3).numpy(),
        np.asarray(jpp._random_initial_states(np.zeros(2), np.ones(2), 2, 4, seed=3)))


def test_diagnostics_on_the_same_chains(posterior):
    """Gelman-Rubin, the sliding rates, the acceptance check, ks_statistics,
    get_log_target_values and the covariance helpers on gpmp_tpu's chains,
    carried into the port."""
    jm = posterior["jmh"]
    tm = _carried_port_mh(jm, posterior[("t", False)])
    for kw in ({}, {"last_n_samples": 100}, {"burnin_period": 50}):
        np.testing.assert_allclose(tm.compute_gelman_rubin_rhat(**kw),
                                   jm.compute_gelman_rubin_rhat(**kw), rtol=TOL)
    for w in (1, 50, 200, 1000):
        np.testing.assert_array_equal(tm.compute_sliding_rates(w), jm.compute_sliding_rates(w))
    rates = jm.compute_sliding_rates(200)
    assert tm.check_acceptance_rates(rates=rates, verbose=False) == jm.check_acceptance_rates(
        rates=rates, verbose=False)
    for kw in (dict(n_blocks=2, n_block_size=100), dict(n_blocks=1, n_block_size=150)):
        a = tm.ks_statistics(return_statistic=True, **kw)
        b = jm.ks_statistics(return_statistic=True, **kw)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=TOL)
    assert _quiet(tm.check_convergence_ks, multi_block_n_blocks=2, multi_block_size=100) == \
        _quiet(jm.check_convergence_ks, multi_block_n_blocks=2, multi_block_size=100)
    for discard in (False, True):
        np.testing.assert_array_equal(
            tpp.get_log_target_values(tm, discard_burnin=discard).numpy(),
            np.asarray(jpp.get_log_target_values(jm, discard_burnin=discard)))
    np.testing.assert_allclose(tm.compute_empirical_covariance_whole_chain(pooled=True),
                               jm.compute_empirical_covariance_whole_chain(pooled=True), rtol=TOL)
    for a, b in zip(tm.compute_empirical_covariance_whole_chain(n_pool=2),
                    jm.compute_empirical_covariance_whole_chain(n_pool=2)):
        np.testing.assert_allclose(a, b, rtol=TOL)
    with pytest.raises(ValueError):
        tpp.get_log_target_values(tmh.MetropolisHastings(lambda x: 0.0))


def test_cov_estimators():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 3)) @ np.array([[1.0, 0.2, 0.0], [0.0, 0.5, 0.1], [0.0, 0.0, 2.0]])
    np.testing.assert_allclose(tknn.estimate_cov_matrix(x).numpy(),
                               np.asarray(jknn.estimate_cov_matrix(x)), rtol=TOL)
    for kw in ({}, dict(n_random=20, n_neighbors=30), dict(n_random=500, n_neighbors=400)):
        a = tknn.estimate_cov_matrix_knn(x, rng=np.random.default_rng(9), **kw)
        b = jknn.estimate_cov_matrix_knn(x, rng=np.random.default_rng(9), **kw)
        assert isinstance(a, torch.Tensor) and a.shape == (3, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL)


@pytest.mark.parametrize("method", ["Haario", "RM"])
def test_proposal_updates_from_the_same_blocks(posterior, method):
    """One adaptation block of each package from the same carried state on
    the same draws (gpmp_tpu's run_samples key split, replayed into the
    port's block): the same chains, rates, proposal parameters and Haario
    factors.  gpmp_tpu's side is the fixture's sampler (its block kernel
    compiled once), put back to its state afterwards."""
    jm = posterior["jmh"]
    arrays, meta = posterior["jmh_state"]
    # the run's state at the end of its burn-in (its later traces are overwritten)
    state = ({k: np.array(v) for k, v in arrays.items()},
             dict(meta, global_iter=200, sampling_mode="burnin"))
    o = jm.options
    tm = tmh.MetropolisHastings(posterior[("t", False)], options=tmh.MHOptions(
        dim=2, n_chains=2, n_pool=o.n_pool, init_msg=None, adaptation_method=method,
        adaptation_interval=o.adaptation_interval, target_acceptance=o.target_acceptance))
    interop.mh_state_from_numpy(tm, state[0], state[1], seed=0)
    jm.set_state(*state)
    try:
        for mode in ("burnin", "sampling_adaptation"):
            jm.set_mode(mode)
            tm.set_mode(mode)
            _key, sub = jax.random.split(jm._key)
            eps, u = _mh_draws(jax.random.split(sub, N_REPLAY), 2, 2)
            tm._draw_block = lambda n, _d=(eps, u): _d
            if method == "Haario":
                jm.run_adaptive_Haario(N_REPLAY)
                tm.run_adaptive_Haario(N_REPLAY)
            else:
                jm.run_adaptive_RM(N_REPLAY, diminishing=(mode == "burnin"))
                tm.run_adaptive_RM(N_REPLAY, diminishing=(mode == "burnin"))
            assert tm.global_iter == jm.global_iter
            i = jm.global_iter + 1
            np.testing.assert_array_equal(tm.accept[:, :i], jm.accept[:, :i])
            np.testing.assert_allclose(tm.x[:, :i], jm.x[:, :i], rtol=0, atol=TOL)
            np.testing.assert_allclose(tm.haario_scaling_factors, jm.haario_scaling_factors,
                                       rtol=TOL)
            for a, b in zip(tm.proposal_distribution_params, jm.proposal_distribution_params):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=TOL)
    finally:
        jm.set_state(*posterior["jmh_state"])


def test_mesh_option():
    from gpmp_tpu_torch.parallel import make_mesh
    from gpmp_tpu_torch.parallel.mesh import Mesh

    lt = _gauss(torch, _t(TARGET_MEAN), _t(TARGET_PREC))
    tmh.MetropolisHastings(lt, options=tmh.MHOptions(dim=2, mesh=make_mesh(1)))
    two = Mesh("cpu", "chains", size=2)
    with pytest.raises(NotImplementedError, match="10c"):
        tmh.MetropolisHastings(lt, options=tmh.MHOptions(dim=2, n_chains=2, mesh=two))
    with pytest.raises(NotImplementedError, match="10c"):
        tnuts.nuts_sample(lt, np.zeros((2, 2)), 5, num_warmup=0, verbose=0,
                          options=tnuts.NUTSOptions(mesh=two))


def test_mvn_jitter_and_single_step():
    """sample_multivariate_normal_with_jitter (jitter escalation on a
    singular covariance), mhstep, default_prop_rnd and the whole-chain
    helpers (tests/test_mcmc.py's helper test)."""
    g = torch.Generator().manual_seed(0)
    y = tmh.sample_multivariate_normal_with_jitter(np.ones(2), np.ones((2, 2)), generator=g)
    assert y.shape == (2,) and torch.all(torch.isfinite(y))
    with pytest.raises(RuntimeError):
        tmh.sample_multivariate_normal_with_jitter(np.zeros(2), -np.eye(2), generator=g)
    mh = tmh.MetropolisHastings(lambda x: -0.5 * torch.sum(x**2),
                                options=tmh.MHOptions(dim=2, n_chains=4, seed=0, init_msg=None))
    mh.proposal_distribution_params = mh._initialize_proposal_distribution_params(
        mh.options.proposal_distribution_param_init)
    xn, acc, lt_n, lt_c = mh.mhstep(np.zeros(2), 0)
    assert np.isfinite(lt_n) and isinstance(acc, bool) and lt_c == 0.0
    assert mh.default_prop_rnd(np.zeros(2), 0).shape == (2,)
    _quiet(mh.scheduler, np.zeros((4, 2)), burnin_period=100, n_steps_total=300)
    C = mh.compute_empirical_covariance_whole_chain(pooled=True)
    assert C.shape == (2, 2) and np.all(np.isfinite(C))
    assert len(mh.compute_empirical_covariance_whole_chain(pooled=False, n_pool=2)) == 2
    mh.recompute_all_chains_full_covariance()
    assert len(mh.proposal_distribution_params) == 4


# ----------------------------------------------------------------------------
# whole runs, port only (tests/test_mcmc.py's targets, budgets, tolerances)
# ----------------------------------------------------------------------------
def _gaussian_log_target():
    return _gauss(torch, _t(TARGET_MEAN), _t(TARGET_PREC))


def test_mh_gaussian_moments():
    options = tmh.MHOptions(
        dim=2, n_chains=4, n_pool=2, adaptation_method="Haario",
        adaptation_interval=50, show_global_progress=False, init_msg=None, seed=0,
    )
    mh = tmh.MetropolisHastings(log_target=_gaussian_log_target(), options=options)
    samples = _quiet(mh.scheduler, chains_state_initial=np.zeros(2), n_steps_total=4000,
                     burnin_period=1500)
    assert isinstance(samples, torch.Tensor)
    post = samples.numpy()[:, mh.burnin_period:, :].reshape(-1, 2)
    np.testing.assert_allclose(post.mean(axis=0), TARGET_MEAN, atol=0.25)
    np.testing.assert_allclose(np.cov(post.T), TARGET_COV, atol=0.5)
    assert "ok" in mh.check_acceptance_rates(verbose=False)
    gr = mh.check_convergence_gelman_rubin(verbose=False)
    assert gr["rhat"].shape == (2,)
    assert np.all(gr["rhat"] < 1.3)


def test_mh_custom_prop_rnd():
    def prop(generator, x):
        return x + 0.8 * torch.randn(x.shape, generator=generator, dtype=x.dtype)

    options = tmh.MHOptions(dim=2, n_chains=4, n_pool=2, adaptation_interval=50,
                            show_global_progress=False, init_msg=None, seed=0)
    mh = tmh.MetropolisHastings(log_target=_gaussian_log_target(), prop_rnd=prop,
                                options=options)
    samples = _quiet(mh.scheduler, chains_state_initial=np.zeros(2), n_steps_total=4000,
                     burnin_period=1000)
    post = samples.numpy()[:, mh.burnin_period:, :].reshape(-1, 2)
    np.testing.assert_allclose(post.mean(axis=0), TARGET_MEAN, atol=0.3)
    np.testing.assert_allclose(np.cov(post.T), TARGET_COV, atol=0.6)
    y, acc, lt_y, lt_x = mh.mhstep(np.zeros(2), 0)
    assert np.asarray(y).shape == (2,)
    with pytest.raises(ValueError):
        tmh.MetropolisHastings(_gaussian_log_target(),
                               prop_rnd=lambda g, x: torch.zeros(3, dtype=torch.float64),
                               options=options)


def test_mh_ks_statistics_shape():
    options = tmh.MHOptions(dim=1, n_chains=2, adaptation_interval=25, init_msg=None, seed=1)
    mh = tmh.MetropolisHastings(lambda x: -0.5 * torch.sum(x**2), options=options)
    _quiet(mh.scheduler, np.zeros(1), n_steps_total=600, burnin_period=200)
    pmat, sig = mh.ks_statistics(n_blocks=2, n_block_size=100)
    assert pmat.shape == (1, 4, 4)
    assert "ok" in mh.check_convergence_ks(multi_block_n_blocks=2, multi_block_size=100,
                                           verbose=False)


def test_mh_burnin_rm():
    options = tmh.MHOptions(dim=2, n_chains=2, adaptation_method="RM",
                            adaptation_interval=50, init_msg=None, seed=5)
    mh = tmh.MetropolisHastings(log_target=_gaussian_log_target(), options=options)
    samples = _quiet(mh.scheduler, chains_state_initial=np.zeros(2), n_steps_total=3000,
                     burnin_period=1500)
    post = samples.numpy()[:, mh.burnin_period:, :].reshape(-1, 2)
    np.testing.assert_allclose(post.mean(axis=0), TARGET_MEAN, atol=0.35)


def test_nuts_gaussian_moments():
    samples, info = tnuts.nuts_sample(_gaussian_log_target(), np.zeros((2, 2)),
                                      num_samples=800, num_warmup=300, seed=0,
                                      progress=False, verbose=0)
    assert isinstance(samples, torch.Tensor) and samples.shape == (800, 2, 2)
    s = samples.numpy().reshape(-1, 2)
    np.testing.assert_allclose(s.mean(axis=0), TARGET_MEAN, atol=0.3)
    np.testing.assert_allclose(np.cov(s.T), TARGET_COV, atol=0.6)
    assert info["divergent"].mean() < 0.1
    assert np.all(info["tree_depth"] >= 1)
    assert info["step_size_final"] > 0
    # the stored log-probability is the target's at the sample
    lp = _gaussian_log_target()
    np.testing.assert_allclose(info["log_prob_trace"][-1],
                               [float(lp(samples[-1, c])) for c in range(2)], rtol=TOL)


def test_nuts_banana_runs():
    def log_prob(x):
        return -(0.25 * x[0] ** 2 + 4.0 * (x[1] - x[0] ** 2) ** 2)

    samples, info = tnuts.nuts_sample(log_prob, np.array([[0.5, 0.5]]), num_samples=300,
                                      num_warmup=200, seed=1, progress=False, verbose=0)
    s = samples.numpy().reshape(-1, 2)
    assert np.isfinite(s).all()
    assert s[:, 1].mean() > 0.3
