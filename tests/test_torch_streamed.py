# tests/test_torch_streamed.py
"""The streamed large-n engine of the port (gpmp_tpu_torch.parallel.streamed,
its kernels' plain versions in gpmp_tpu_torch.ops.streamed and K6 in
ops.mixed) against gpmp_tpu.parallel.streamed, on the CPU, on the same numpy
inputs (n = 512, d = 3, the kernel of tests/test_parallel_streamed.py).

The kernels (K6, K10b, K10r, K10m, K10t) run only on a CUDA card; here their
plain versions run, and chip_smoke.py holds the kernels to them on the card.
Tolerances, each with its reason:

- K6: rel 1e-6 (two f32 products, summed in another order than XLA's);
- K10b: bitwise (both sides round the same f64 values to f32 and the
  remainder), on a table kernel that hands both the same f64 rows;
- K10r: max |diff| <= 2 f32 ulps of max |R| (K - L L^T in f64 in another
  order, one f32 rounding; the JAX package's diagonal blocks are symmetric
  only to roundoff);
- K10m: rel 1e-13 (f64 sums of f32 x f64 products in another order);
- K10t: tr H, sum Hr o Hc^T rel 1e-12 (f64 sums of exact products); the
  H^2 terms rel 1e-5 (H^2 is an f32 product in another order);
- the engine: the JAX package's own bars (test_parallel_streamed.py:73-122):
  X to 1e-7, log det to 1e-11 N |ld| (ff) / 1e-12 N |ld| (recompute), the
  gradient within the class envelope (rtol 1e-3, atol 1e-6 max|g|), the
  B cotangent to 1e-7; the REML value through the mesh to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.config as jconfig
import gpmp_tpu.num as jgnp
import gpmp_tpu.parallel.streamed as jst
from gpmp_tpu.ops import mixed as jmixed
from gpmp_tpu.parallel import make_mesh as jmake_mesh
from gpmp_tpu.parallel.likelihood import (
    _diag_correction as j_diag_correction,
    sharded_negative_log_restricted_likelihood as j_sharded_reml,
)

import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import mixed, streamed as ops
from gpmp_tpu_torch.parallel import (
    ShardedModelView,
    likelihood as tlik,
    make_mesh,
    sharded_cholesky,
    streamed as st,
)

N, D = 512, 3
P0 = np.array([0.0, np.log(1e-2), 0.3, 0.2, 0.1])
P_ILL = np.array([0.0, np.log(3e-7), 1.0, 1.0, 1.0])
# an H100 80GB HBM3's torch.cuda.get_device_properties(0).total_memory
# (printed by chip_smoke.py phase 3d) and the dispatcher's 0.85 of it
H100_TOTAL_BYTES = 85_017_493_504
H100_CAP = int(0.85 * H100_TOTAL_BYTES)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _kernel_for(gp, gnp):
    def kernel(x, y, param, pairwise=False):
        sigma2 = gnp.exp(param[0])
        noise = gnp.exp(param[1])
        loginvrho = param[2:]
        if y is x or y is None:
            if pairwise:
                return (sigma2 + noise) * gnp.ones((x.shape[0],))
            Dm = gnp.scaled_distance(loginvrho, x, x)
            return sigma2 * gp.kernel.maternp_kernel(2, Dm) + noise * gnp.eye(Dm.shape[0])
        Dm = (gnp.scaled_distance_elementwise if pairwise
              else gnp.scaled_distance)(loginvrho, x, y)
        return sigma2 * gp.kernel.maternp_kernel(2, Dm)

    return kernel


def _models():
    return (jgp.Model(lambda x, p: jgnp.ones((x.shape[0], 1)), _kernel_for(jgp, jgnp)),
            tgp.Model(lambda x, p: tgnp.ones((x.shape[0], 1)), _kernel_for(tgp, tgnp)))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def problem():
    config.set_device("cpu")
    jmodel, tmodel = _models()
    rng = np.random.default_rng(0)
    xi = rng.uniform(size=(N, D))
    zi = np.sin(3 * xi[:, 0]) + 0.1 * rng.normal(size=N)
    B = rng.normal(size=(N, 2))
    K = tlik.sharded_covariance(tmodel, _t(P0), _t(xi), None).numpy()
    return jmodel, tmodel, xi, zi, B, K


@pytest.fixture(scope="module")
def pair(problem):
    """(K32, E32, L32, M32) of the problem's K, the ff engine's residents."""
    _j, _t_, _x, _z, _B, K = problem
    K32 = K.astype(np.float32)
    E32 = (K - K32.astype(np.float64)).astype(np.float32)
    L32, info = st._cholesky_f32(_t(K32).clone(), torch.tensor(
        10 * np.finfo(np.float32).eps * np.trace(K32) / N, dtype=torch.float32))
    assert int(info) == 0
    M32 = mixed._block_tri_inv(L32)
    return K32, E32, L32, M32


# ---------------------------------------------------------------------------
# plain kernel versions vs the JAX functions they replace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 8, 9, 64])
def test_k6_precond_apply_plain_matches_jax(pair, k):
    _K32, _E32, _L32, M32 = pair
    R = np.random.default_rng(k).normal(size=(N, k))
    out = mixed.precond_apply_plain(M32, _t(R))
    assert out.dtype == torch.float64
    for jfn in (jst._apply_precond, jmixed._apply):
        ref = np.asarray(jax.jit(jfn)(M32.numpy(), R))
        assert _rel(out.numpy(), ref) <= 1e-6
    # the dispatcher and the engine's _apply: the plain version on CPU tensors,
    # no launch counted
    before = mixed.K6_LAUNCHES
    assert torch.equal(mixed._apply(M32, _t(R)), out) and mixed.K6_LAUNCHES == before


class _Table:
    """A covariance that returns rows of a fixed f64 table, indexed by the
    points' single coordinate: both packages build from the same f64 rows."""

    def __init__(self, T, xp):
        self.T, self.xp = T, xp

    def covariance(self, x, y, p):
        if self.xp is jnp:
            return self.T[x[:, 0].astype(jnp.int32)][:, y[:, 0].astype(jnp.int32)]
        return self.T[x[:, 0].long()][:, y[:, 0].long()]


@pytest.mark.parametrize("ridge", [None, 3e-5])
def test_k10b_split_rows_plain_matches_jax(problem, ridge):
    """ff: the pair of _build_ff; recompute: _build_k32 with the ridge."""
    *_, K = problem
    rng = np.random.default_rng(5)
    corr = rng.uniform(1e-3, 1e-2, size=N)
    idx = np.arange(N, dtype=np.float64)[:, None]
    chunk = 128
    jt = _Table(jnp.asarray(K), jnp)
    tt = _Table(_t(K), torch)
    if ridge is None:
        hi_j, lo_j = jax.jit(lambda x, c: jst._build_ff(jt, None, x, c, chunk))(idx, corr)
        hi, lo = st._build_pair(tt, None, _t(idx), _t(corr), chunk, pair=True)
        assert np.array_equal(lo.numpy(), np.asarray(lo_j))
        # the pair holds K + diag(corr) to eps32^2 relative
        V = _t(K) + torch.diag(_t(corr))
        assert float(torch.max(torch.abs(hi.double() + lo.double() - V))) <= 2.0**-47 * float(V.max())
    else:
        hi_j = jax.jit(lambda x, c, r: jst._build_k32(jt, None, x, c, chunk, ridge=r))(
            idx, corr, jnp.float64(ridge))
        hi, lo = st._build_pair(tt, None, _t(idx), _t(corr), chunk, pair=False,
                                ridge=ridge)
        assert lo is None
    assert hi.dtype == torch.float32 and np.array_equal(hi.numpy(), np.asarray(hi_j))


@pytest.mark.parametrize("block", [100, tlik.DIAG_CORRECTION_BLOCK])
def test_diag_correction_matches_jax(problem, block):
    """The noise diagonal the cross-covariance gram lacks; blocks of 100
    leave a ragged last block."""
    jmodel, tmodel, xi, *_ = problem
    c = tlik._diag_correction(tmodel, _t(P0), _t(xi), block=block).numpy()
    cj = np.asarray(jax.jit(lambda p: j_diag_correction(jmodel, p, jnp.asarray(xi)))(P0))
    assert c.shape == (N,)
    np.testing.assert_allclose(c, cj, rtol=1e-12)
    np.testing.assert_allclose(c, np.exp(P0[1]), rtol=1e-12)


@pytest.mark.parametrize("chunk", [128, N])
def test_recompute_ridge_matches_jax(problem, chunk):
    """Recompute mode's Cholesky ridge comes from mean(diag K) before the
    K32 build: the self-branch diagonal, noise variance included, as
    _diag_self_mean gives it in the JAX package."""
    jmodel, tmodel, xi, *_, K = problem
    m = float(st._diag_self_mean(tmodel, _t(P0), _t(xi), chunk))
    mj = float(jax.jit(lambda p: jst._diag_self_mean(jmodel, p, jnp.asarray(xi), chunk))(P0))
    assert m == pytest.approx(mj, rel=1e-14)
    assert m == pytest.approx(np.mean(np.diag(K)), rel=1e-14)
    assert m == pytest.approx(np.exp(P0[0]) + np.exp(P0[1]), rel=1e-14)


@pytest.mark.parametrize("block", [128, N])
def test_k10r_streamed_residual_plain_matches_jax(problem, pair, block):
    """Both sources of K (the pair, f64 column panels) against
    _streamed_residual_f32: block 128 runs its panel loop, block N its dense
    form."""
    *_, K = problem
    K32, E32, L32, _M32 = pair
    K64 = K32.astype(np.float64) + E32.astype(np.float64)
    Rj = np.asarray(jax.jit(lambda K_, L_: jst._streamed_residual_f32(
        lambda c0, w: K_[c0:, c0:c0 + w], L_, N, block, block))(K64, L32.numpy()))
    tol = 2 * np.spacing(np.float32(np.max(np.abs(Rj))))
    R_ff = ops.streamed_residual_ff(_t(K32), _t(E32), L32, block)
    R_panel = torch.empty((N, N), dtype=torch.float32)
    for c0 in range(0, N, block):
        ops.residual_panel(_t(K64[c0:, c0:c0 + block]).contiguous(), L32, c0, R_panel)
    for R in (R_ff, R_panel):
        assert R.dtype == torch.float32 and torch.equal(R, R.T)
        assert np.max(np.abs(R.numpy() - Rj)) <= tol
    assert torch.equal(R_ff, R_panel)


def test_k10m_ff_residual_plain_matches_jax(pair):
    K32, E32, _L32, _M32 = pair
    rng = np.random.default_rng(9)
    X, B = rng.normal(size=(N, 3)), rng.normal(size=(N, 3))
    R, norms = ops.ff_residual(_t(K32), _t(E32), _t(X), _t(B))
    Rj = np.asarray(jax.jit(lambda K_, E_, X_, B_: B_ - jst._matvec_ff(K_, E_, X_))(
        K32, E32, X, B))
    assert _rel(R.numpy(), Rj) <= 1e-13
    np.testing.assert_allclose(norms.numpy(), [np.sum(Rj ** 2), np.sum(B ** 2)], rtol=1e-13)


def test_k10t_h_traces_plain_matches_jax():
    rng = np.random.default_rng(2)
    A = 1e-3 * rng.normal(size=(N, N))
    H = (A + A.T).astype(np.float32)
    H[3, 5] += np.float32(1e-6)  # not exactly symmetric: Hc^T is not Hr
    c = st._h_traces(_t(H), 128).numpy()
    cj = np.array(jax.jit(lambda H_: jst._h_traces(H_, 128))(H))
    np.testing.assert_allclose(c[:2], cj[:2], rtol=1e-12)
    np.testing.assert_allclose(c[2:], cj[2:], rtol=1e-5)


# ---------------------------------------------------------------------------
# the engine, both modes, against JAX's streamed engine and numpy
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_engine(problem):
    """JAX's streamed engine per mode: X, ld and the gradient of ld + sum X."""
    jmodel, _tm, xi, _zi, B, _K = problem
    out = {}
    for mode in ("ff", "recompute"):
        def f(p, mode=mode):
            X, ld = jst.streamed_mp_solve_and_logdet(jmodel, p, jnp.asarray(xi), B, mode=mode)
            return ld + jnp.sum(X), (X, ld)

        (_v, (X, ld)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(P0))
        out[mode] = (np.asarray(X), float(ld), np.asarray(g))
    return out


def _exact_grad(tmodel, xi, B):
    p = _t(P0).clone().requires_grad_(True)
    C = torch.linalg.cholesky(tlik.sharded_covariance(tmodel, p, _t(xi), None))
    f = 2.0 * torch.sum(torch.log(torch.diagonal(C))) + torch.cholesky_solve(_t(B), C).sum()
    return torch.autograd.grad(f, p)[0].numpy()


@pytest.mark.parametrize("mode", ["ff", "recompute"])
def test_streamed_engine_matches_jax_and_oracle(problem, jax_engine, mode):
    _jm, tmodel, xi, _zi, B, K = problem
    p = _t(P0).clone().requires_grad_(True)
    X, ld = st.streamed_mp_solve_and_logdet(tmodel, p, _t(xi), _t(B), mode=mode)
    (g,) = torch.autograd.grad(ld + X.sum(), p)
    X, ld, g = X.detach().numpy(), float(ld.detach()), g.numpy()
    Xj, ldj, gj = jax_engine[mode]
    Xref = np.linalg.solve(K, B)
    _s, ld_ref = np.linalg.slogdet(K)
    tol = (1e-11 if mode == "ff" else 1e-12) * abs(ld_ref) * N
    np.testing.assert_allclose(X, Xref, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(X, Xj, rtol=1e-7, atol=1e-10)
    assert abs(ld - ld_ref) <= tol and abs(ld - ldj) <= tol
    g_exact = _exact_grad(tmodel, xi, B)
    for ref in (g_exact, gj):
        np.testing.assert_allclose(g, ref, rtol=1e-3, atol=1e-6 * np.abs(g_exact).max())


@pytest.mark.parametrize("mode", ["ff", "recompute"])
def test_streamed_b_cotangent(problem, mode):
    """Bbar = K^{-1} Xbar: the gradient with respect to the rhs is exact."""
    _jm, tmodel, xi, _zi, B, K = problem
    w = np.random.default_rng(3).normal(size=(N, 2))
    Bt = _t(B).clone().requires_grad_(True)
    X, _ld = st.streamed_mp_solve_and_logdet(tmodel, _t(P0), _t(xi), Bt, mode=mode)
    (g,) = torch.autograd.grad(torch.sum(_t(w) * X), Bt)
    np.testing.assert_allclose(g.numpy(), np.linalg.solve(K, w), rtol=1e-7, atol=1e-10)


@pytest.fixture
def forced(monkeypatch):
    """The streamed engine forced on at n >= 256 with the mixed engine
    configured, in both packages (their GPMP_STREAM_N)."""
    monkeypatch.setattr(st, "STREAM_MIN_N", 256)
    monkeypatch.setattr(jst, "STREAM_MIN_N", 256)
    prev_t, prev_j = config.get_chol_engine(), jconfig.get_chol_engine()
    config.set_chol_engine("mixed")
    jconfig.set_chol_engine("mixed")
    yield make_mesh(1, axis_name="shard")
    config.set_chol_engine(prev_t)
    jconfig.set_chol_engine(prev_j)


def test_streamed_non_pd_yields_nan_and_inf(problem, forced):
    _jm, tmodel, xi, zi, B, _K = problem
    p_bad = _t(P0).clone()
    p_bad[0] = torch.nan
    p_bad.requires_grad_(True)
    X, ld = st.streamed_mp_solve_and_logdet(tmodel, p_bad, _t(xi), _t(B), mode="ff")
    assert not np.isfinite(float(ld.detach())) and not bool(torch.isfinite(X).any())
    (g,) = torch.autograd.grad(ld + X.sum(), p_bad)
    assert not bool(torch.isfinite(g).any())
    crit = tgp.kernel.make_selection_criterion_with_gradient(
        ShardedModelView(tmodel, forced), tgp.kernel.negative_log_restricted_likelihood,
        xi, zi)
    assert crit[0](p_bad.detach().numpy()) == np.inf
    assert np.all(crit[3](p_bad.detach().numpy()) == 0.0)


def test_streamed_robust_branch_ill_conditioned(problem):
    """At p_ill (cond(K) ~1e6) the engine gives ld to 1e-6 on whichever
    branch its gate takes, and with robust=False NaN or that value."""
    _jm, tmodel, _xi, _zi, _B, _K = problem
    rng = np.random.default_rng(7)
    xi = rng.uniform(size=(N, D))
    B = rng.normal(size=N)
    K = tlik.sharded_covariance(tmodel, _t(P_ILL), _t(xi), None).numpy()
    _s, ld_ref = np.linalg.slogdet(K)
    for robust in (True, False):
        _X, ld = st.streamed_mp_solve_and_logdet(tmodel, _t(P_ILL), _t(xi), _t(B), mode="ff",
                                                 robust=robust)
        assert (not robust and not np.isfinite(float(ld))) or (
            abs(float(ld) - ld_ref) < 1e-6 * max(abs(ld_ref), 1.0))


def test_streamed_robust_branch_forced(problem, monkeypatch):
    """At n = 512 the series gate passes even at p_ill (c4 ~1e-7 in both
    packages), so the gate is forced shut: the second-level logdet and the
    robust K^{-1} of the backward, against numpy and the exact gradient;
    with robust=False, NaN."""
    _jm, tmodel, xi, _zi, B, K = problem
    monkeypatch.setattr(st, "_SERIES_C4_TAU", 0.0)
    calls = []
    robust_ld = st._StreamedOperator._robust_ld
    monkeypatch.setattr(st._StreamedOperator, "_robust_ld",
                        lambda self, *a: calls.append(1) or robust_ld(self, *a))
    p = _t(P0).clone().requires_grad_(True)
    X, ld = st.streamed_mp_solve_and_logdet(tmodel, p, _t(xi), _t(B), mode="ff", robust=True)
    (g,) = torch.autograd.grad(ld + X.sum(), p)
    _s, ld_ref = np.linalg.slogdet(K)
    assert calls and abs(float(ld.detach()) - ld_ref) < 1e-6 * max(abs(ld_ref), 1.0)
    g_exact = _exact_grad(tmodel, xi, B)
    np.testing.assert_allclose(g.numpy(), g_exact, rtol=1e-3, atol=1e-6 * np.abs(g_exact).max())
    p = _t(P0).clone().requires_grad_(True)
    X, ld = st.streamed_mp_solve_and_logdet(tmodel, p, _t(xi), _t(B), mode="ff", robust=False)
    (g,) = torch.autograd.grad(ld + X.sum(), p)
    assert np.isnan(float(ld.detach())) and bool(torch.isnan(g).all())


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_reml_vg(problem):
    """JAX's sharded REML value+grad on its one-device mesh, traced once
    with its streamed engine forced (the compiled program keeps it)."""
    jmodel, _tm, xi, zi, _B, _K = problem
    mesh = jmake_mesh(1, axis_name="shard")
    fn = jax.jit(jax.value_and_grad(lambda p: j_sharded_reml(
        jmodel, p, jnp.asarray(xi), jnp.asarray(zi), mesh, block=128)))
    prev_n, prev_e = jst.STREAM_MIN_N, jconfig.get_chol_engine()
    jst.STREAM_MIN_N = 256
    jconfig.set_chol_engine("mixed")
    try:
        fn(jnp.asarray(P0))
    finally:
        jst.STREAM_MIN_N = prev_n
        jconfig.set_chol_engine(prev_e)

    def vg(p):
        v, g = fn(jnp.asarray(p))
        return float(v), np.asarray(g)

    return vg


def test_streamed_reml_dispatch_matches_jax(problem, forced, jax_reml_vg):
    _jm, tmodel, xi, zi, _B, _K = problem
    calls = []
    sal = st.streamed_mp_solve_and_logdet
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(st, "streamed_mp_solve_and_logdet",
                   lambda *a, **k: calls.append(1) or sal(*a, **k))
        p = _t(P0).clone().requires_grad_(True)
        v = tlik.sharded_negative_log_restricted_likelihood(tmodel, p, _t(xi), _t(zi), forced)
        (g,) = torch.autograd.grad(v, p)
    assert calls  # it ran on the streamed engine
    vj, gj = jax_reml_vg(P0)
    assert abs(float(v.detach()) - vj) <= 1e-8 * abs(vj)
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-3, atol=1e-6)
    # the zero-mean NLL through the view on the same engine, against numpy
    nll = ShardedModelView(tmodel, forced).negative_log_likelihood_zero_mean(
        _t(P0), _t(xi), _t(zi))
    K = problem[5]
    _s, ld = np.linalg.slogdet(K)
    ref = 0.5 * (N * np.log(2 * np.pi) + ld + zi @ np.linalg.solve(K, zi))
    assert abs(float(nll) - ref) <= 1e-8 * abs(ref)


def test_dispatch_memory_model_h100():
    """The peak-bytes model at an H100 80GB's cap: the mesh's resident mixed
    branch (9.0 units of 4n^2 bytes per value+grad) holds n = 32768, n = 51200
    is past it and streams in recompute mode, a forced stream at 32768 takes
    ff with room for the robust branch, and every n up to recompute's
    ceiling has a route (no dispatch gap)."""
    assert st._resident_fits(16384, cap_bytes=H100_CAP)
    assert st._resident_fits(32768, cap_bytes=H100_CAP)
    assert not st._resident_fits(51200, cap_bytes=H100_CAP)
    assert st.choose_mode(51200, cap_bytes=H100_CAP) == "recompute"
    assert st.choose_mode(32768, cap_bytes=H100_CAP) == "ff"
    assert st._robust_fits(32768, cap_bytes=H100_CAP)
    ceiling = max(n for n in range(512, 131072, 512)
                  if st.choose_mode(n, cap_bytes=H100_CAP) is not None)
    assert ceiling >= 40960
    for n in range(4096, ceiling + 1, 512):
        assert (st._resident_fits(n, cap_bytes=H100_CAP)
                or st.choose_mode(n, cap_bytes=H100_CAP) is not None), n
    assert st.choose_mode(ceiling + 512, cap_bytes=H100_CAP) is None


def test_kernel_is_f32_polymorphic(problem):
    _jm, tmodel, xi, *_ = problem
    assert st.kernel_is_f32_polymorphic(tmodel, _t(P0), _t(xi))
    kernel = _kernel_for(tgp, tgnp)
    model64 = tgp.Model(tmodel.mean, lambda x, y, p, pairwise=False: kernel(
        x, y, p, pairwise).to(torch.float64))
    assert not st.kernel_is_f32_polymorphic(model64, _t(P0), _t(xi))
    # JAX's probe agrees on both
    assert jst.kernel_is_f32_polymorphic(problem[0], jnp.asarray(P0), jnp.asarray(xi))


# ---------------------------------------------------------------------------
# the edges
# ---------------------------------------------------------------------------
def test_unported_mesh_branches_raise(problem):
    """Meshes of more than one card stay unported and raise, through every
    entry point of the mesh path; the one-card resident branch, factor=,
    predict and LOO run (tests/test_torch_parallel.py)."""
    _jm, tmodel, xi, zi, _B, K = problem
    assert make_mesh(1).shape == {"batch": 1} and make_mesh(1).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="item 11"):
        make_mesh(2)
    two = make_mesh(1, axis_name="shard")
    two.size, two.shape = 2, {"shard": 2}
    with pytest.raises(NotImplementedError, match="more than one card"):
        tlik.sharded_negative_log_restricted_likelihood(tmodel, _t(P0), _t(xi), _t(zi), two)
    with pytest.raises(NotImplementedError, match="more than one card"):
        sharded_cholesky(_t(K), two, block=128)
    view = ShardedModelView(tgp.Model(tmodel.mean, tmodel.covariance, covparam=P0), two)
    with pytest.raises(NotImplementedError, match="more than one card"):
        view.predict(xi, zi, xi[:4])
    with pytest.raises(NotImplementedError, match="more than one card"):
        view.loo(xi, zi)
    with pytest.raises(NotImplementedError, match="item 11"):
        tgp.kernel.select_parameters_with_reml(tmodel, xi, zi, covparam0=P0, mesh=two)


@pytest.mark.parametrize("where", ["criterion", "view", "select"])
def test_resident_panel_size_raises(problem, where):
    """The resident branch's panel size (the criterion's block=, the view's
    block=, select_parameters_with_reml's shard_block=) is honoured: the f64
    REML with panels of 128 matches JAX's sharded REML with block=128 to
    1e-12 (both the same exact blocked algorithm), and a panel that does not
    divide n is refused.  (While only the streamed engine was ported, these
    were refused.)"""
    jmodel, tmodel, xi, zi, _B, _K = problem
    prev = config.get_chol_engine()
    config.set_chol_engine("f64")
    mesh = make_mesh(1, axis_name="shard")
    try:
        vj = float(jax.jit(lambda p: j_sharded_reml(
            jmodel, p, jnp.asarray(xi), jnp.asarray(zi), jmake_mesh(1, axis_name="shard"),
            block=128))(jnp.asarray(P0)))
        if where == "criterion":
            v = float(tlik.sharded_negative_log_restricted_likelihood(
                tmodel, _t(P0), _t(xi), _t(zi), mesh, block=128))
            with pytest.raises(ValueError, match="divisible"):
                tlik.sharded_negative_log_restricted_likelihood(
                    tmodel, _t(P0), _t(xi), _t(zi), mesh, block=96)
        elif where == "view":
            view = ShardedModelView(tmodel, mesh, block=128)
            assert view._block_for(N) == 128
            assert ShardedModelView(tmodel, mesh)._block_for(N) == 512
            v = float(view.negative_log_restricted_likelihood(_t(P0), _t(xi), _t(zi)))
        else:
            model, info = tgp.kernel.select_parameters_with_reml(
                tmodel, xi, zi, covparam0=P0, mesh=mesh, shard_block=128, method="L-BFGS-B",
                method_options={"maxiter": 1}, info=True)
            v = float(info.history_criterion[0])
            assert model is tmodel and info.fun <= v
    finally:
        config.set_chol_engine(prev)
    assert abs(v - vj) <= 1e-12 * abs(vj)


def test_select_parameters_with_reml_on_a_mesh(problem, forced):
    """The fit of example 40 on the one-card mesh, streaming forced: it
    converges, and JAX's sharded REML (its default engine on its one-device
    mesh: the exact f64 Cholesky) agrees at the port's optimum.  The data
    are bench_large_n.py's function with a noise of 0.2, so that the
    optimum is interior and cond(K) moderate (~5e4); at the problem's data
    two length scales run to their bounds, cond(K) reaches ~1e6, and the
    engine class is only ~1e-8 from f64 there (JAX's streamed engine too)."""
    jmodel, tmodel, xi, _zi, _B, _K = problem
    zi = (np.sin(3.0 * xi[:, 0]) + 0.5 * xi[:, 1] + 0.25 * xi[:, 2] ** 2
          + 0.2 * np.random.default_rng(1).normal(size=N))
    model, info = tgp.kernel.select_parameters_with_reml(
        tmodel, xi, zi, covparam0=P0, mesh=forced, method="L-BFGS-B", info=True)
    assert model is tmodel and info.success and np.isfinite(info.fun)
    assert info.fun < info.history_criterion[0]
    p_opt = tmodel.covparam.numpy()
    assert np.allclose(p_opt, info.x)
    vj = float(jax.jit(lambda p: j_sharded_reml(
        jmodel, p, jnp.asarray(xi), jnp.asarray(zi), jmake_mesh(1, axis_name="shard"),
        block=128))(jnp.asarray(p_opt)))
    assert abs(info.fun - vj) <= 1e-8 * abs(vj)


def test_subsampled_initial_guess_matches_jax(problem):
    """Mesh mode's initial guess (covparam0 None): the dense heuristic on the
    same deterministic subsample, for a built-in Matern kernel."""
    from gpmp_tpu.kernel.parameter_selection import _subsampled_initial_guess as j_guess

    _jm, _tm, xi, zi, _B, _K = problem
    models = [gp.Model(lambda x, p, gnp=gnp: gnp.ones((x.shape[0], 1)),
                       lambda x, y, c, pairwise=False, gp=gp: gp.kernel.maternp_covariance(
                           x, y, 2, c, pairwise))
              for gp, gnp in ((jgp, jgnp), (tgp, tgnp))]
    p_j = np.asarray(j_guess(models[0], xi, zi, 256))
    p_t = tgp.kernel.parameter_selection._subsampled_initial_guess(models[1], xi, zi, 256)
    assert p_t.shape == (1 + D,)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-10)
