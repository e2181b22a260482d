# tests/test_torch_tri_product.py
"""The launch geometry and tile walks of K8t (the refined panel's
triangular product, gpmp_tpu_torch.ops.refine.tri_product_plan) and K8s (the
sampling root's residual K - L L^T on K4's tiles), on the CPU.

The kernels run only on a CUDA card (chip_smoke.py phases 2c and 2e hold
them to their plain versions there).  Here: K8t's plan covers every lower
entry of a (b, b) matrix once, and its k chunks cover [j0, min(i0 + 32, b))
in order, in whole 8-column steps, for ragged and whole b; a tile-by-tile
walk of the product with the kernel's masks, chunks and warp-order sum
equals ``tri_product_plain`` and gpmp_tpu's products (``newton_tri_inv``,
L + L Phi(X)) within one unit of 2 b eps64 (|beta| |A| + |alpha| |A| |f(B)|)
entrywise (f64 sums of up to b products in another order); K8s's f64 walk
over ``residual_tiles`` equals ``sampling_residual_plain`` and gpmp_tpu's
K - L L^T within 1e-14 of max|K| and rounds to K4's f32 walk bitwise; and
the wrappers refuse what the kernels do not take.
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
from gpmp_tpu.ops import refine as jrefine

from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import _build, mixed, refine

EPS64 = float(np.finfo(np.float64).eps)
PANELS = (1, 3, 100, 256, 488, 512)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _spd(n, seed):
    """A noisy Matern-5/2 covariance on uniform points in [0, 1]^3."""
    x = np.random.default_rng(seed).uniform(size=(n, 3))
    D = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) / 0.3
    return (1 + np.sqrt(5) * D + 5 / 3 * D ** 2) * np.exp(-np.sqrt(5) * D) + 1e-2 * np.eye(n)


def _refine_inputs(b, seed):
    """The panel refinement's operands: L = the f32 factor promoted, M its
    f32 inverse promoted, P = L M, X a full matrix (the Ogita-Aishima
    correction M E M^T)."""
    A = torch.as_tensor(_spd(b, seed))
    L32 = torch.linalg.cholesky(A.float())
    L = L32.double()
    M = torch.linalg.solve_triangular(L32, torch.eye(b), upper=False).double()
    P = refine.tri_product_plain(L, M)
    E, _ = refine.refine_residual_plain(A, L)
    return L, M, P, (M @ E @ M.T)


# ---------------------------------------------------------------------------
# K8t's plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", PANELS)
def test_k8t_plan_covers_the_lower_triangle_and_each_k_range(b):
    plan = refine.tri_product_plan(b)
    T, W, KS = refine.TRI_TILE, refine.TRI_WARPS, refine.TRI_KS
    assert plan.dtype == torch.int32 and plan.shape[1] == refine.TRI_PLAN
    nt = -(-b // T)
    assert plan.shape[0] == nt * (nt + 1) // 2
    count = np.zeros((b, b), dtype=np.int16)
    lengths = []
    for row in plan.tolist():
        i0, j0, ks = row[0], row[1], row[2:3 + W]
        assert 0 <= j0 <= i0 < b and i0 % T == 0 and j0 % T == 0 and row[3 + W:] == [0]
        count[i0:i0 + T, j0:j0 + T] += 1
        kend = min(i0 + T, b)
        # the chunks: contiguous, in order, from j0 to the tile's k end, the
        # inner bounds at whole KS-column steps (even: 16-byte copies)
        assert ks[0] == j0 and ks[-1] == kend
        assert all(lo <= hi for lo, hi in zip(ks[:-1], ks[1:]))
        assert all((k - j0) % KS == 0 for k in ks[:-1])
        steps = [-(-(hi - lo) // KS) for lo, hi in zip(ks[:-1], ks[1:])]
        assert max(steps) - min(steps) <= 1 and sum(steps) == -(-(kend - j0) // KS)
        lengths.append(kend - j0)
    lower = np.tril(np.ones((b, b), dtype=bool))
    assert np.all(count[lower] == 1) and np.all(count <= 1)
    assert lengths == sorted(lengths, reverse=True) and lengths[0] == b
    with pytest.raises(ValueError):
        refine.tri_product_plan(0)


@pytest.mark.parametrize("built,ok", [((32, 8, 8, 12), True), ((64, 8, 8, 12), False),
                                      ((32, 4, 8, 8), False)])
def test_k8t_plan_is_the_built_kernels(built, ok):
    """The wrapper builds plans only for a kernel of the same geometry
    (csrc/chol.cu's gpmp_tri_product_geometry)."""

    class Lib:
        def gpmp_tri_product_geometry(self, q):
            return built[q]

    if ok:
        refine._tri_geometry(Lib())
    else:
        with pytest.raises(RuntimeError, match="geometry"):
            refine._tri_geometry(Lib())


# ---------------------------------------------------------------------------
# K8t's walk, in plain torch
# ---------------------------------------------------------------------------
def _k8t_walk(A, B, beta, alpha, phi):
    """K8t tile by tile over its plan: each warp's chunk of the masked
    product, the partials summed in warp order, beta A + alpha C on i >= j,
    zeros above (the mirror tile's and the diagonal tile's); NaN where no
    block wrote."""
    b = A.shape[0]
    T, W = refine.TRI_TILE, refine.TRI_WARPS
    Al = torch.tril(A)
    fB = refine._phi(B) if phi else torch.tril(B)
    C = torch.full((b, b), float("nan"), dtype=torch.float64)
    for row in refine.tri_product_plan(b).tolist():
        i0, j0, ks = row[0], row[1], row[2:3 + W]
        i1, j1 = min(i0 + T, b), min(j0 + T, b)
        S = torch.zeros((i1 - i0, j1 - j0), dtype=torch.float64)
        for lo, hi in zip(ks[:-1], ks[1:]):
            S = S + Al[i0:i1, lo:hi] @ fB[lo:hi, j0:j1]
        low = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
        C[i0:i1, j0:j1] = torch.where(low, beta * A[i0:i1, j0:j1] + alpha * S, 0.0)
        if i0 != j0:
            C[j0:j1, i0:i1] = 0.0
    return C


def _units(C, ref, A, B, beta, alpha, phi, absB=None):
    """max |C - ref| in units of 2 b eps64 (|beta| |A| + |alpha| |A| |f(B)|);
    absB, where given, stands for |f(B)| (a bound of B's magnitude)."""
    b = A.shape[0]
    fB = refine._phi(B) if phi else torch.tril(B)
    absB = fB.abs() if absB is None else absB
    scale = 2 * b * EPS64 * (abs(beta) * A.abs() + abs(alpha) * (torch.tril(A).abs() @ absB))
    d = (torch.as_tensor(C) - torch.as_tensor(np.array(ref))).abs()
    return float(torch.where(d > 0, d / scale, torch.zeros_like(d)).max())


@pytest.mark.parametrize("b", PANELS)
def test_k8t_tile_walk_matches_plain_and_jax(b):
    L, M, P, X = _refine_inputs(b, 40 + b)
    cases = {"L M": (L, M, 0.0, 1.0, False), "2M - M P": (M, P, 2.0, -1.0, False),
             "L + L Phi(X)": (L, X, 1.0, 1.0, True)}
    walks = {}
    for tag, (a_, b_, beta, alpha, phi) in cases.items():
        walk = _k8t_walk(a_, b_, beta, alpha, phi)
        assert not torch.isnan(walk).any(), tag
        assert bool((torch.triu(walk, 1) == 0).all()), tag
        plain = refine.tri_product_plain(a_, b_, beta, alpha, phi)
        assert _units(walk, plain, a_, b_, beta, alpha, phi) <= 1.0, tag
        walks[tag] = walk
    # the JAX package's products on the same inputs
    Ln, Mn, Xn = L.numpy(), M.numpy(), X.numpy()
    ref_lm = np.asarray(jax.jit(lambda l, m: l @ m)(Ln, Mn))
    assert _units(walks["L M"], ref_lm, L, M, 0.0, 1.0, False) <= 1.0
    # the Newton step M (2I - L M): 2M - M P with P the walk's L M, against
    # gpmp_tpu's newton_tri_inv, which forms its own L M: |f(B)| is then
    # bounded by |L| |M| (P ~ I is a sum of terms that cancel; each side's
    # P carries b eps64 |L| |M| into the step)
    newton = _k8t_walk(M, walks["L M"], 2.0, -1.0, False)
    ref_newton = np.asarray(jax.jit(lambda l, m: jrefine.newton_tri_inv(l, m, steps=1))(Ln, Mn))
    assert _units(newton, ref_newton, M, P, 2.0, -1.0, False, L.abs() @ M.abs()) <= 1.0
    ref_update = np.asarray(jax.jit(lambda l, x: l + l @ jrefine._phi(x))(Ln, Xn))
    assert _units(walks["L + L Phi(X)"], ref_update, L, X, 1.0, 1.0, True) <= 1.0


def test_k8t_beta_zero_reads_no_a_above_the_product():
    """beta = 0: the walk's C is alpha tril(A) f(B) alone; A's upper triangle
    (not read by the kernel) does not reach C."""
    b = 100
    L, M, _P, _X = _refine_inputs(b, 9)
    junk = L + torch.triu(torch.full((b, b), 7.0), 1)
    walk = _k8t_walk(junk, M, 0.0, 1.0, False)
    assert torch.equal(walk, _k8t_walk(L, M, 0.0, 1.0, False))


# ---------------------------------------------------------------------------
# K8s's walk over K4's tiles
# ---------------------------------------------------------------------------
def _k8s_walk(K, L32, tile):
    """K8s (f64 K) tile by tile over residual_tiles: each tile's sum over
    k < min(j0 + tile, n) in f64, its lower entries written and mirrored."""
    n = K.shape[0]
    L = L32.double()
    E = torch.full((n, n), float("nan"), dtype=torch.float64)
    for i0, j0 in mixed.residual_tiles(n, tile).tolist():
        i1, j1 = min(i0 + tile, n), min(j0 + tile, n)
        blk = K[i0:i1, j0:j1] - L[i0:i1, :j1] @ L[j0:j1, :j1].T
        low = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
        E[i0:i1, j0:j1] = torch.where(low, blk, E[i0:i1, j0:j1])
        up = E[j0:j1, i0:i1]
        up.copy_(torch.where(low.T, blk.T, up))
    return E


@pytest.mark.parametrize("n", [257, 300])
def test_k8s_tile_walk_matches_plain_and_jax(n):
    K = _spd(n, 70 + n)
    Kt = torch.as_tensor(K)
    L32, _ = mixed._f32_preconditioner(Kt)
    tile = mixed.RESIDUAL_TILE
    walk = _k8s_walk(Kt, L32, tile)
    assert walk.dtype == torch.float64 and not torch.isnan(walk).any()
    assert torch.equal(walk, walk.T)
    plain = refine.sampling_residual_plain(Kt, L32)
    ref = np.asarray(jax.jit(lambda k, l: k - l @ l.T)(K, L32.double().numpy()))
    bar = 1e-14 * np.max(np.abs(K))
    assert float((walk - plain).abs().max()) <= bar
    assert np.max(np.abs(walk.numpy() - ref)) <= bar
    assert np.max(np.abs(plain.numpy() - ref)) <= bar
    # K4 is the same tiles and sums rounded to f32: K8s(K, L32).float() is
    # bitwise K4(K, L32) (the card's gate, chip_smoke phase 2c)
    k4 = torch.full((n, n), float("nan"), dtype=torch.float32)
    L = L32.double()
    for i0, j0 in mixed.residual_tiles(n, tile).tolist():
        i1, j1 = min(i0 + tile, n), min(j0 + tile, n)
        blk = (Kt[i0:i1, j0:j1] - L[i0:i1, :j1] @ L[j0:j1, :j1].T).float()
        k4[i0:i1, j0:j1] = blk
        k4[j0:j1, i0:i1] = blk.T
    assert torch.equal(walk.float(), k4)


# ---------------------------------------------------------------------------
# the wrappers and the launch path
# ---------------------------------------------------------------------------
def test_k8s_k8t_wrappers_refuse():
    """CPU tensors to the *_cuda entries raise, none falls back; the
    dispatchers take the plain versions on the CPU and count no launch."""
    K = torch.as_tensor(_spd(64, 1))
    L32, _ = mixed._f32_preconditioner(K)
    L = L32.double()
    for call in (lambda: refine.sampling_residual_cuda(K, L32),
                 lambda: refine.sampling_residual_cuda(K.float(), L32),
                 lambda: refine.tri_product_cuda(L, L),
                 lambda: refine.tri_product_cuda(L, L, 1.0, 1.0, True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    before = (refine.K8S_LAUNCHES, refine.K8T_LAUNCHES)
    assert torch.equal(refine.sampling_residual(K, L32), refine.sampling_residual_plain(K, L32))
    assert torch.equal(refine.tri_product(L, L), refine.tri_product_plain(L, L))
    assert (refine.K8S_LAUNCHES, refine.K8T_LAUNCHES) == before


def test_load_takes_no_lock_once_loaded(monkeypatch):
    """Once the library is loaded, _build.load() returns it without the
    lock (every launch calls it)."""

    class Refuse:
        def __enter__(self):
            raise AssertionError("the lock was taken")

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "_lock", Refuse())
    assert _build.load() is lib
