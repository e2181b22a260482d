# tests/test_torch_population.py
"""The population form of the Matern gram (K1p and K2p, ops.gram) and the
batching rules of the port's autograd Functions, on the CPU in f64, held
to the single plain versions and to gpmp_tpu's ``jax.vmap`` of the
criterion.

- ``population_plan``: K1p's grid (member groups x chunks) and K2p's (warps
  of one member's chunk) cover every (member, i, j) once, walked here as
  the kernels walk them.
- The plain versions: ``matern_gram_population_plain`` bitwise the single
  plain version member by member; the population pullback within 1e-14 of
  it (x is y and cross, d in {1, 3, 9}, p in {0, 3, 5}).
- The batching rules: ``torch.func.vmap`` of ``MaternGram`` over theta is
  the population form, over x the plain composition; ``vmap(grad)`` of
  <W, K> goes through ``_GramPullback``'s rule; ``_SafeSqrt``,
  ``_ScaledDistance`` and ``_MaternpKernel`` batch by their generated
  rules; on CUDA tensors any batching but theta's raises (checked on the
  rule's decision), and the kernels' wrappers refuse CPU tensors.
- The REMAP criterion of example23's data (ni = 8, seed 0):
  ``vmap(crit)`` against the loop (1e-14 relative) and against gpmp_tpu's
  ``jax.vmap(crit)`` at 64 points around the MAP (1e-11 relative, the
  criteria's agreement floor: tests/test_torch_mcmc.py's probe), its
  gradient under ``vmap(grad)`` likewise (|diff| <= 1e-11 max(1, |g|)); the
  support check of the barrier prior skipped under a transform only.
- ``mcmc.population``'s route: vmap for the criterion, particle by particle
  for the mixed Cholesky engine (its convergence tests read values back:
  ``ops.capture.reads_back``), both equal to the loop.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.kernel  # noqa: F401
import gpmp_tpu.num as jgnp
from gpmp_tpu.mcmc import param_posterior as jpp
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.kernel import priors as tpriors
from gpmp_tpu_torch.mcmc import param_posterior as tpp
from gpmp_tpu_torch.mcmc import population
from gpmp_tpu_torch.ops import capture, distance, gram

TOL_FLOOR = 1e-11  # the REMAP criteria's agreement floor, port vs gpmp_tpu
N_POINTS = 64


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _model(gp, gnp):
    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 3, covparam, pairwise)

    return gp.Model(mean, kernel)


def _inputs(B, n, m, d, same, seed=0):
    rng = np.random.default_rng(seed)
    x = _t(rng.uniform(-1, 1, size=(n, d)))
    y = x if same else _t(rng.uniform(-1, 1, size=(m, d)))
    thetas = _t(np.c_[rng.normal(size=B), rng.normal(scale=0.5, size=(B, d))])
    kbars = _t(rng.normal(size=(B, n, x.shape[0] if same else m)))
    return x, y, thetas, kbars


# ----------------------------------------------------------------------------
# K1p's and K2p's plans
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("B,n,m", [(1000, 8, 8), (7, 30, 30), (3, 40, 20), (65, 5, 5),
                                   (2, 1, 1), (5, 33, 17)])
def test_population_plan_covers_every_entry_once(B, n, m):
    (mb, chunks, blocks), (wchunks, wblocks) = gram.population_plan(B, n, m)
    per = n * m
    seen = np.zeros(B * per, dtype=int)
    for blk in range(blocks):  # K1p: block g c, a thread an entry of the chunk
        g, c = divmod(blk, chunks)
        b0 = g * mb
        nb = min(mb, B - b0)
        e = np.arange(c * gram.POP_CHUNK, (c + 1) * gram.POP_CHUNK)
        e = e[e < nb * per]
        np.add.at(seen, b0 * per + e, 1)
    assert (seen == 1).all()
    assert mb * per <= gram.POP_CHUNK or mb == 1
    assert mb <= gram.POP_MAX_MEMBERS
    seen[:] = 0
    warps = wblocks * (gram.POP_THREADS // 32)
    assert warps >= B * wchunks > warps - gram.POP_THREADS // 32
    for w in range(B * wchunks):  # K2p: warp w, member w // chunks
        b, c = divmod(w, wchunks)
        e = np.arange(c * gram.POP_WARP_ENTRIES, min(per, (c + 1) * gram.POP_WARP_ENTRIES))
        np.add.at(seen, b * per + e, 1)
    assert (seen == 1).all()


def test_population_plan_refuses_empty():
    with pytest.raises(ValueError):
        gram.population_plan(0, 8, 8)


# ----------------------------------------------------------------------------
# the plain versions
# ----------------------------------------------------------------------------
CASES = [(5, 9, 9, 1, True, 3), (4, 12, 7, 3, False, 0), (3, 10, 10, 9, True, 5),
         (1, 6, 6, 2, True, 1)]


@pytest.mark.parametrize("B,n,m,d,same,p", CASES)
def test_population_plain_is_the_single_plain(B, n, m, d, same, p):
    x, y, thetas, kbars = _inputs(B, n, m, d, same)
    K = gram.matern_gram_population_plain(x, y, p, thetas, same)
    g = gram.matern_gram_population_pullback_plain(kbars, x, y, p, thetas, same)
    assert K.shape == (B, n, y.shape[0]) and g.shape == (B, d + 1) and g.dtype == torch.float64
    for b in range(B):
        torch.testing.assert_close(K[b], gram.matern_gram_plain(x, y, p, thetas[b], same),
                                   rtol=0, atol=0)
        gb = gram.matern_gram_pullback_plain(kbars[b], x, y, p, thetas[b], same)
        torch.testing.assert_close(g[b], gb, rtol=1e-14, atol=1e-14 * float(gb.abs().max()))
    # the dispatch on CPU tensors is the plain version
    torch.testing.assert_close(gram.matern_gram_population(x, y, p, thetas, same), K,
                               rtol=0, atol=0)
    torch.testing.assert_close(gram.matern_gram_population_pullback(kbars, x, y, p, thetas, same),
                               g, rtol=0, atol=0)


def test_population_cuda_wrappers_refuse_cpu_tensors():
    x, y, thetas, kbars = _inputs(3, 5, 5, 2, True)
    with pytest.raises(ValueError, match="CUDA"):
        gram.matern_gram_population_cuda(x, x, 3, thetas, True)
    with pytest.raises(ValueError, match="CUDA"):
        gram.matern_gram_population_pullback_cuda(kbars, x, x, 3, thetas, True)


class _PopLib:
    """Stands in for the built library: K1/K2's and K1p/K2p's geometry as
    csrc/matern_gram.cu gives it; every other entry is its own name."""

    geometry = (gram.THREADS, gram.TILE, gram.EXACT_MAX_D, gram.MAX_D, gram.FIXED_P,
                gram.BLOCKS_PER_SM)
    population = (gram.POP_THREADS, gram.POP_CHUNK, gram.POP_MAX_MEMBERS,
                  gram.POP_WARP_ENTRIES, gram.POP_EXACT_D)

    def gpmp_matern_geometry(self, q):
        return self.geometry[q]

    def gpmp_matern_population_geometry(self, q):
        return self.population[q]

    def __getattr__(self, name):
        return name


def _clear_caches():
    for fn in (gram._library, gram._population_library, gram._plan_on,
               gram._population_pullback_workspace):
        fn.cache_clear()


def test_population_wrappers_launch_their_entries(monkeypatch):
    """With the tensors taken for CUDA ones (is_cuda patched, the library and
    the launch stood in for): bad arguments raise before anything is built;
    a good call launches its entry once with the arguments in the C
    entry's order (csrc/matern_gram.cu), the plan and the cached workspace;
    a library of another population geometry is refused."""
    x, _y, thetas, kbars = _inputs(70, 9, 9, 2, True)
    launched, loads = [], []
    monkeypatch.setattr(gram, "K1P_LAUNCHES", 0)
    monkeypatch.setattr(gram, "K2P_LAUNCHES", 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(gram._build, "load", lambda: loads.append(1) or _PopLib())
    monkeypatch.setattr(gram._build, "launch",
                        lambda name, fn, dev, *args: launched.append((fn, args)))
    _clear_caches()
    for bad in (lambda: gram.matern_gram_population_cuda(x, x, 3, thetas[0], True),
                lambda: gram.matern_gram_population_cuda(x, x, 3, thetas.float(), True),
                lambda: gram.matern_gram_population_cuda(x, x, 3, thetas.T.contiguous().T, True),
                lambda: gram.matern_gram_population_cuda(x, x, 3, thetas[:, :2], True),
                lambda: gram.matern_gram_population_pullback_cuda(kbars[:5], x, x, 3, thetas, True),
                lambda: gram.matern_gram_population_cuda(x, x.clone(), 3, thetas, True)):
        with pytest.raises(ValueError):
            bad()
    assert not launched and not loads
    K = gram.matern_gram_population_cuda(x, x, 3, thetas, True)
    g = gram.matern_gram_population_pullback_cuda(kbars, x, x, 5, thetas, True)
    assert [fn for fn, _ in launched] == ["gpmp_matern_gram_population_f64",
                                          "gpmp_matern_pullback_population_f64"]
    (_, fwd), (_, pb) = launched
    eps = float(np.finfo(np.float64).eps)
    (mb, chunks, blocks), (wchunks, wblocks) = gram.population_plan(70, 9, 9)
    assert fwd[:3] == (x.data_ptr(), x.data_ptr(), thetas.data_ptr())
    assert list(fwd[3]) == gram._coef_values(3) and fwd[4] is None
    assert fwd[5:] == (K.data_ptr(), 70, 9, 9, 2, 3, 1, eps, mb, chunks, blocks)
    ws = gram._population_pullback_workspace(x.device, 70, 9, 9, 2)
    assert pb[:4] == (kbars.data_ptr(), x.data_ptr(), x.data_ptr(), thetas.data_ptr())
    assert list(pb[4]) == gram._coef_values(5)
    assert pb[5] == gram._coef_tensor(5, x.device).data_ptr()
    assert pb[6:8] == ws[2:4]
    assert pb[8:] == (g.data_ptr(), 70, 9, 9, 2, 5, 1, eps, wchunks, wblocks)
    assert K.shape == (70, 9, 9) and g.shape == (70, 3) and g.dtype == torch.float64
    assert (gram.K1P_LAUNCHES, gram.K2P_LAUNCHES) == (1, 1) and len(loads) == 1
    _clear_caches()
    monkeypatch.setattr(_PopLib, "population", (128, *_PopLib.population[1:]))
    with pytest.raises(RuntimeError, match="K1p/K2p geometry"):
        gram.matern_gram_population_cuda(x, x, 3, thetas, True)
    _clear_caches()


# ----------------------------------------------------------------------------
# the batching rules
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("B,n,m,d,same,p", CASES[:3])
def test_maternGram_vmap_over_theta_is_the_population(B, n, m, d, same, p):
    x, y, thetas, kbars = _inputs(B, n, m, d, same)
    K = torch.func.vmap(lambda t: gram.matern_gram(x, y, p, t, same))(thetas)
    torch.testing.assert_close(K, gram.matern_gram_population_plain(x, y, p, thetas, same),
                               rtol=0, atol=0)
    # vmap(grad) of <W, K(theta)>: the pullback's rule
    W = kbars
    g = torch.func.vmap(torch.func.grad(
        lambda t, w: torch.sum(w * gram.matern_gram(x, y, p, t, same))))(thetas, W)
    ref = gram.matern_gram_population_pullback_plain(W, x, y, p, thetas, same)
    torch.testing.assert_close(g, ref, rtol=1e-13, atol=1e-13 * float(ref.abs().max()))


def test_maternGram_vmap_over_x_is_the_plain_composition():
    _, _, thetas, _ = _inputs(1, 6, 6, 2, True)
    xs = _t(np.random.default_rng(3).uniform(size=(4, 6, 2)))
    K = torch.func.vmap(lambda xx: gram.matern_gram(xx, xx, 2, thetas[0], True))(xs)
    for b in range(4):
        torch.testing.assert_close(K[b], gram.matern_gram_plain(xs[b], xs[b], 2, thetas[0], True),
                                   rtol=1e-15, atol=0)
    g = torch.func.vmap(torch.func.grad(
        lambda xx: torch.sum(gram.matern_gram(xx, xx, 2, thetas[0], True))))(xs)
    for b in range(4):
        xb = xs[b].clone().requires_grad_(True)
        (gb,) = torch.autograd.grad(torch.sum(gram.matern_gram(xb, xb, 2, thetas[0], True)), xb)
        torch.testing.assert_close(g[b], gb, rtol=1e-13, atol=1e-13)


def test_batching_of_cuda_tensors_other_than_theta_raises():
    card = types.SimpleNamespace(is_cuda=True)
    host = types.SimpleNamespace(is_cuda=False)
    assert gram._population_dims("MaternGram", None, None, (card, card, card))
    with pytest.raises(NotImplementedError, match="batches theta only"):
        gram._population_dims("MaternGram", 0, None, (card, card, card))
    with pytest.raises(NotImplementedError, match="y along 1"):
        gram._population_dims("the gram pullback", None, 1, (host, card))
    assert not gram._population_dims("MaternGram", 0, None, (host, host))


@pytest.mark.parametrize("which", ["safe_sqrt", "scaled_distance", "elementwise", "maternp"])
def test_generated_vmap_rules_match_the_loop(which):
    rng = np.random.default_rng(5)
    x, y = _t(rng.uniform(size=(7, 3))), _t(rng.uniform(size=(7, 3)))
    ls = _t(rng.normal(scale=0.3, size=(5, 3)))
    fns = {
        "safe_sqrt": lambda l: tgnp._safe_sqrt(torch.cat([torch.exp(l), l[:1] * 0])),
        "scaled_distance": lambda l: distance.scaled_distance(l, x, y),
        "elementwise": lambda l: distance.scaled_distance_elementwise(l, x, y),
        "maternp": lambda l: gram.maternp_kernel(2, distance.scaled_distance(l, x, x)),
    }
    fn = fns[which]

    def scalar(l):
        return torch.sum(torch.sin(fn(l)))

    v = torch.func.vmap(fn)(ls)
    g = torch.func.vmap(torch.func.grad(scalar))(ls)
    for b in range(ls.shape[0]):
        torch.testing.assert_close(v[b], fn(ls[b]), rtol=1e-15, atol=0)
        lb = ls[b].clone().requires_grad_(True)
        (gb,) = torch.autograd.grad(scalar(lb), lb)
        torch.testing.assert_close(g[b], gb, rtol=1e-13, atol=1e-14)


# ----------------------------------------------------------------------------
# the REMAP criterion over a population
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def remap():
    """Example23's data (ni = 8, seed 0), both packages' REMAP fits (the
    gaussian-logsigma2-and-logrho prior, as bench_samplers.py), their
    criteria and 64 points around the MAP; gpmp_tpu's jax.vmap of the
    criterion and of its gradient, jitted once."""
    config.set_device("cpu")
    torch.set_num_threads(2)
    xi = np.asarray(jgp.misc.designs.ldrandunif(1, 8, [[-1], [1]], seed=0))
    zi = np.asarray(jgp.misc.testfunctions.twobumps(xi))
    sel = "select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior"
    _, ji = getattr(jgp.kernel, sel)(_model(jgp, jgnp), xi, zi, info=True)
    _, ti = getattr(tgp.kernel, sel)(_model(tgp, tgnp), xi, zi, info=True)
    jc = jpp._resolve_selection_criterion(ji, None, require_differentiable=True)
    tc = tpp._resolve_selection_criterion(ti, None, require_differentiable=True)
    pm = np.asarray(ji["covparam"])
    pts = pm + 0.3 * np.random.default_rng(11).normal(size=(N_POINTS, 2))
    jv = np.asarray(jax.jit(jax.vmap(jc))(jnp.asarray(pts)))
    jg = np.asarray(jax.jit(jax.vmap(jax.grad(jc)))(jnp.asarray(pts)))
    return {"xi": xi, "zi": zi, "tinfo": ti, "tcrit": tc, "pts": pts, "jv": jv, "jg": jg}


def _loop(crit, pts):
    vals, grads = [], []
    for p in pts:
        q = _t(p).requires_grad_(True)
        v = crit(q)
        (g,) = torch.autograd.grad(v, q)
        vals.append(float(v.detach()))
        grads.append(g.numpy())
    return np.array(vals), np.array(grads)


def test_vmapped_criterion_is_the_loop_and_gpmp_tpus_vmap(remap):
    crit, pts = remap["tcrit"], _t(remap["pts"])
    v = torch.func.vmap(crit)(pts).numpy()
    g, v2 = (a.numpy() for a in torch.func.vmap(torch.func.grad_and_value(crit))(pts))
    lv, lg = _loop(crit, remap["pts"])
    err = {"vmap vs loop": float(np.max(np.abs(v - lv) / np.abs(lv))),
           "grad_and_value's value vs loop": float(np.max(np.abs(v2 - lv) / np.abs(lv))),
           "vmap grad vs loop": float(np.max(np.abs(g - lg) / np.maximum(1.0, np.abs(lg)))),
           "vs gpmp_tpu": float(np.max(np.abs(v - remap["jv"]) / np.abs(remap["jv"]))),
           "grad vs gpmp_tpu": float(np.max(np.abs(g - remap["jg"])
                                            / np.maximum(1.0, np.abs(remap["jg"]))))}
    print("REMAP criterion over 64 points:", err)
    assert err["vmap vs loop"] <= 1e-14
    assert err["grad_and_value's value vs loop"] <= 1e-14
    assert err["vmap grad vs loop"] <= TOL_FLOOR
    assert err["vs gpmp_tpu"] <= TOL_FLOOR and err["grad vs gpmp_tpu"] <= TOL_FLOOR


def test_population_criterion_routes(remap):
    crit, pts = remap["tcrit"], _t(remap["pts"][:8])
    pc = population.Criterion(crit)
    out = pc(pts)
    assert pc.route == "vmap"
    lv = np.array([float(crit(p)) for p in pts])
    np.testing.assert_allclose(out.numpy(), lv, rtol=1e-14)
    assert not capture.reads_back(crit, pts[0])
    assert capture.reads_back(lambda t: torch.ones(()) * float(t[0]), pts[0])


def test_mixed_engine_goes_particle_by_particle():
    """At n >= 192 the mixed engine reads convergence tests back: the
    population route is particle by particle, equal to the loop, and within
    the engine's accuracy of the f64 engine's vmapped values."""
    rng = np.random.default_rng(2)
    xi = rng.uniform(size=(200, 2))
    zi = np.sin(3 * xi[:, 0]) + xi[:, 1] ** 2 + 0.05 * rng.normal(size=200)

    def kernel(x, y, c, pairwise=False):
        if y is x or y is None:
            if pairwise:
                return (tgnp.exp(c[0]) + tgnp.exp(c[1])) * tgnp.ones((x.shape[0],))
            D = tgnp.scaled_distance(c[2:], x, x)
            return (tgnp.exp(c[0]) * tgp.kernel.maternp_kernel(2, D)
                    + tgnp.exp(c[1]) * tgnp.eye(x.shape[0]))
        D = tgnp.scaled_distance(c[2:], x, y)
        return tgnp.exp(c[0]) * tgp.kernel.maternp_kernel(2, D)

    model = tgp.Model(lambda x, p: tgnp.ones((x.shape[0], 1)), kernel)
    crit = tgp.kernel.make_selection_criterion_with_gradient(
        model, tgp.kernel.negative_log_restricted_likelihood, tgnp.asarray(xi),
        tgnp.asarray(zi))[0]
    single = tpp._traceable_from_wrapper(crit)
    p0 = np.r_[np.log(np.var(zi)), np.log(1e-2 * np.var(zi)), -np.log(np.std(xi, axis=0))]
    pts = _t(p0 + 0.1 * rng.normal(size=(4, 4)))
    pc = population.Criterion(single)
    f64 = pc(pts)
    assert pc.route == "vmap"
    try:
        config.set_chol_engine("mixed")
        mixed = pc(pts)
        assert pc.route == "particles"
        np.testing.assert_array_equal(mixed.numpy(), [float(single(p)) for p in pts])
    finally:
        config.set_chol_engine("auto")
    np.testing.assert_allclose(mixed.numpy(), f64.numpy(), rtol=1e-6)


def test_prior_support_check_skipped_under_transforms_only():
    lmin, l0 = np.array([0.0]), np.array([-1.0])  # l0 <= lmin: outside the support
    with pytest.raises(ValueError, match="logrho_0"):
        tpriors.neglog_f_logrho(_t([0.5]), lmin, l0)
    out = torch.func.vmap(lambda l: tpriors.neglog_f_logrho(l, lmin, l0))(_t([[0.5], [1.0]]))
    assert out.shape == (2, 1)
