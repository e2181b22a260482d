# tests/test_torch_refine_residual.py
"""The launch geometry and walks of K8r (the refined panel's residual and
guard sums, gpmp_tpu_torch.ops.refine.refine_residual_plan) and K3 (the
refinement residual B - K X, gpmp_tpu_torch.ops.mixed.residual_column_chunks),
on the CPU.

The kernels run only on a CUDA card (chip_smoke.py phases 2b, 2e and 2f
hold them to their plain versions there).  Here: K8r's plan covers every
lower entry of a (b, b) panel once, and its k chunks cover
[0, min(j0 + 32, b)) in order, in whole 8-column steps; a tile-by-tile walk
with the kernel's chunks, warp-order sum, mirror and guard sums equals
``refine_residual_plain`` and gpmp_tpu's A - L L^T within 1e-14 of max|A|
(f64 sums of up to b products in another order), E exactly symmetric, the
sums within chip_smoke's TOL_2E["K8r sums"] (1e-5 on sum E^2, whose ~eps32
|A| entries move by ~b eps64 |A| with the sum order; 1e-13 on sum A^2);
K3's column chunks tile [0, n) in whole 128-column steps and give the grid
about two blocks an SM, and a walk that sums each chunk
and then the chunks in order equals ``residual_plain`` and gpmp_tpu's
``_f64_matvec`` residual within 1e-13 of max|B| + max|K||X| (n products in
another order); ``refined_cholesky`` and ``residual`` on CPU tensors take
the plain versions (no launch, no graph) and match gpmp_tpu's; the wrappers
refuse what the kernels do not take.
"""

import contextlib
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
from gpmp_tpu.ops import mixed as jmixed
from gpmp_tpu.ops import refine as jrefine

from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import mixed, refine

PANELS = (1, 3, 100, 256, 488, 512)
H100_SMS = 132  # the card's SM count, as K3's wrapper reads it there


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _spd(n, seed):
    """A noisy Matern-5/2 covariance on uniform points in [0, 1]^3."""
    x = np.random.default_rng(seed).uniform(size=(n, 3))
    D = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) / 0.3
    return (1 + np.sqrt(5) * D + 5 / 3 * D ** 2) * np.exp(-np.sqrt(5) * D) + 1e-2 * np.eye(n)


# ---------------------------------------------------------------------------
# K8r's plan and walk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", PANELS)
def test_k8r_plan_covers_the_lower_triangle_and_each_k_range(b):
    plan = refine.refine_residual_plan(b)
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
        kend = min(j0 + T, b)
        # the chunks: contiguous, in order, from 0 to the tile's last column,
        # the inner bounds at whole KS-column steps
        assert ks[0] == 0 and ks[-1] == kend
        assert all(lo <= hi for lo, hi in zip(ks[:-1], ks[1:]))
        assert all(k % KS == 0 for k in ks[:-1])
        steps = -(-kend // KS)
        assert max(hi - lo for lo, hi in zip(ks[:-1], ks[1:])) <= KS * -(-steps // W)
        lengths.append(kend)
    assert np.array_equal(np.tril(count), np.tril(np.ones((b, b), dtype=np.int16)))
    assert lengths == sorted(lengths, reverse=True)


def _k8r_walk(A, L):
    """K8r tile by tile over its plan: each warp's chunk summed on its own,
    the chunks in warp order, E = A - C on i >= j and mirrored; each tile's
    (sum E^2, sum A^2) with the off-diagonal entries twice, the tiles'
    pairs summed in plan order."""
    b = A.shape[0]
    T, W = refine.TRI_TILE, refine.TRI_WARPS
    E = torch.full((b, b), float("nan"), dtype=torch.float64)
    pairs = []
    for row in refine.refine_residual_plan(b).tolist():
        i0, j0, ks = row[0], row[1], row[2:3 + W]
        i1, j1 = min(i0 + T, b), min(j0 + T, b)
        C = torch.zeros((i1 - i0, j1 - j0), dtype=torch.float64)
        for kb, ke in zip(ks[:-1], ks[1:]):
            C = C + L[i0:i1, kb:ke] @ L[j0:j1, kb:ke].T
        blk = A[i0:i1, j0:j1] - C
        low = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
        E[i0:i1, j0:j1] = torch.where(low, blk, E[i0:i1, j0:j1])
        up = E[j0:j1, i0:i1]
        up.copy_(torch.where(low.T, blk.T, up))
        w = torch.where(torch.arange(j0, j1)[None, :] == torch.arange(i0, i1)[:, None], 1.0, 2.0)
        pairs.append(torch.stack([torch.sum(torch.where(low, w * blk * blk, 0.0)),
                                  torch.sum(torch.where(low, w * A[i0:i1, j0:j1] ** 2, 0.0))]))
    return E, torch.stack(pairs).sum(0)


@pytest.mark.parametrize("b", [3, 100, 256, 488])
def test_k8r_walk_matches_plain_and_jax(b):
    A = torch.as_tensor(_spd(b, 40 + b))
    L = torch.linalg.cholesky(A.float()).double()
    E, sums = _k8r_walk(A, L)
    assert not torch.isnan(E).any() and torch.equal(E, E.T)
    Ep, sums_p = refine.refine_residual_plain(A, L)
    Ej = np.asarray(jax.jit(lambda a, l: a - l @ l.T)(A.numpy(), L.numpy()))
    bar = 1e-14 * float(A.abs().max())
    assert float((E - Ep).abs().max()) <= bar
    assert np.max(np.abs(E.numpy() - Ej)) <= bar
    # sum E^2: E ~ eps32 |A| differs by ~b eps64 |A| between sum orders, ~1e-6
    # relative (chip_smoke's TOL_2E["K8r sums"]); sum A^2: exact products
    sums_j = np.array([np.sum(Ej * Ej), np.sum(A.numpy() ** 2)])
    for got in (sums, sums_p):
        err = np.abs(got.numpy() - sums_j) / sums_j
        assert err[0] <= 1e-5 and err[1] <= 1e-13


# ---------------------------------------------------------------------------
# K3's column chunks and walk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,n", [(1, 1), (1000, 1000), (1024, 1024), (4099, 4099),
                                    (2050, 4099), (2049, 4099), (8192, 8192), (16384, 16384),
                                    (3, 300), (640, 50000)])
def test_k3_column_chunks_tile_each_row(rows, n):
    step, block_rows = mixed.RESIDUAL_STEP, mixed.RESIDUAL_BLOCK_ROWS
    chunks, width = mixed.residual_column_chunks(rows, n, H100_SMS)
    assert chunks >= 1 and width % step == 0 and width > 0
    # [c w, min((c + 1) w, n)) for c < chunks: contiguous, none empty, to n
    assert (chunks - 1) * width < n <= chunks * width
    row_blocks = -(-rows // block_rows)
    target = mixed.RESIDUAL_BLOCKS_PER_SM * H100_SMS
    steps = -(-n // step)
    # enough chunks that the grid reaches the target, or one a step
    assert row_blocks * chunks >= target or chunks == steps or width == step
    # and no more than that needs
    assert chunks == 1 or row_blocks * (chunks - 1) < target
    if (rows, n) == (1000, 1000):
        assert (chunks, width) == (8, 128)
    if n >= 8448 and rows == n:
        assert chunks == 1


def _k3_walk(K, X, B):
    """K3 chunk by chunk: each chunk's K X summed on its own, the chunks in
    order, R = B - K X, the norms over R and B."""
    rows, n = K.shape
    chunks, width = mixed.residual_column_chunks(rows, n, H100_SMS)
    S = torch.zeros(B.shape, dtype=torch.float64)
    for c in range(chunks):
        c0, c1 = c * width, min((c + 1) * width, n)
        S = S + K[:, c0:c1].double() @ X[c0:c1].double()
    R = (B.double() - S).to(B.dtype)
    return R, torch.stack([torch.sum(R.double() ** 2), torch.sum(B.double() ** 2)])


@pytest.mark.parametrize("rows,n,k", [(300, 300, 2), (1000, 1000, 1), (1000, 1000, 3),
                                      (1024, 1024, 8), (2050, 4099, 2)])
def test_k3_walk_matches_plain_and_jax(rows, n, k):
    rng = np.random.default_rng(rows + n + k)
    K = _spd(n, n)[:rows]
    X, B = rng.normal(size=(n, k)), rng.normal(size=(rows, k))
    Kt, Xt, Bt = map(torch.as_tensor, (K, X, B))
    R, norms = _k3_walk(Kt, Xt, Bt)
    Rp, norms_p = mixed.residual_plain(Kt, Xt, Bt)
    Rj = B - np.asarray(jax.jit(jmixed._f64_matvec)(K, X))
    bar = 1e-13 * (np.max(np.abs(B)) + np.max(np.abs(K)) * np.max(np.abs(X)) * n ** 0.5)
    assert float((R - Rp).abs().max()) <= bar
    assert np.max(np.abs(R.numpy() - Rj)) <= bar
    assert float(((norms - norms_p).abs() / norms_p).max()) <= 1e-12
    # float32 K, X and B: the products and sums in f64, R rounded once
    R32, _ = _k3_walk(Kt.float(), Xt.float(), Bt.float())
    assert R32.dtype == torch.float32
    ref = (Bt.float().double() - Kt.float().double() @ Xt.float().double()).float()
    assert float((R32 - ref).abs().max()) <= float(np.finfo(np.float32).eps) * float(
        ref.abs().max())


# ---------------------------------------------------------------------------
# the CPU dispatch and the wrappers
# ---------------------------------------------------------------------------
def test_cpu_dispatch_takes_the_plain_versions():
    """refined_cholesky and residual on CPU tensors run the plain versions:
    no launch is counted and no graph is made, and the results match
    gpmp_tpu's refined_cholesky and _f64_matvec."""
    before = (refine.K8R_LAUNCHES, refine.K8T_LAUNCHES, mixed.K3_LAUNCHES,
              len(refine._PANEL_GRAPHS))
    A = _spd(256, 5)
    L, M = refine.refined_cholesky(torch.as_tensor(A), with_inverse=True)
    Lj, Mj = jax.jit(lambda a: jrefine.refined_cholesky(a, with_inverse=True))(A)
    for got, ref in ((L, Lj), (M, Mj)):
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    rng = np.random.default_rng(6)
    X, B = rng.normal(size=(256, 2)), rng.normal(size=(256, 2))
    R, norms = mixed.residual(*map(torch.as_tensor, (A, X, B)))
    Rp, norms_p = mixed.residual_plain(*map(torch.as_tensor, (A, X, B)))
    assert torch.equal(R, Rp) and torch.equal(norms, norms_p)
    Rj = B - np.asarray(jax.jit(jmixed._f64_matvec)(A, X))
    assert np.max(np.abs(R.numpy() - Rj)) <= 1e-13 * np.max(np.abs(Rj))
    assert (refine.K8R_LAUNCHES, refine.K8T_LAUNCHES, mixed.K3_LAUNCHES,
            len(refine._PANEL_GRAPHS)) == before


def test_k8r_k3_wrappers_refuse():
    """CPU tensors to the *_cuda entries raise; none falls back."""
    A = torch.as_tensor(_spd(64, 1))
    X = torch.ones((64, 2), dtype=torch.float64)
    for call in (lambda: refine.refine_residual_cuda(A, A),
                 lambda: mixed.residual_cuda(A, X, X),
                 lambda: mixed.residual_cuda(A.float(), X.float(), X.float())):
        with pytest.raises(ValueError, match="CUDA"):
            call()


class _FakeLib:
    """The built library's entries that the panel graph's caches read."""

    gpmp_refine_residual = object()

    @staticmethod
    def gpmp_tri_product_geometry(q):
        return (refine.TRI_TILE, refine.TRI_WARPS, refine.TRI_KS, refine.TRI_PLAN)[q]


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def replay(self):
        pass


def test_panel_graph_holds_what_it_captured(monkeypatch):
    """The panel graph keeps the tensors whose addresses it captured (K8t's
    plan, K8r's plan, pairs and ticket) alive when their caches drop them.
    The capture is stood in for on the CPU: the launch sequence fetches
    the launch state from the caches, as its launches do on the card, and
    runs its plain versions, and the stream and graph calls do nothing."""
    monkeypatch.setattr(refine._build, "load", lambda: _FakeLib)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    plain_sequence = refine._refined_cholesky_launches

    def sequence(A, steps, with_inverse, rtol2):
        refine._tri_plan_on(A.device, A.shape[0])
        refine._refine_residual_on(A.device, A.shape[0])
        return plain_sequence(A, steps, with_inverse, rtol2)

    monkeypatch.setattr(refine, "_refined_cholesky_launches", sequence)
    caches = (refine._tri_plan_on, refine._refine_residual_on)
    dev, b = torch.device("cpu"), 64
    for cache in caches:
        cache.cache_clear()
    try:
        graph = refine._panel_graph(dev, b, 2, True, refine._FACTOR_RTOL2)
        tri_plan = refine._tri_plan_on(dev, b)
        _, plan, _, pairs, ticket, tensors = refine._refine_residual_on(dev, b)
        refs = [weakref.ref(t) for t in (tri_plan, *tensors)]
        del tri_plan, tensors
        for cache in caches:
            cache.cache_clear()
        gc.collect()
        assert all(ref() is not None for ref in refs)
        assert all(t is ref() for t, ref in zip(graph.held, refs, strict=True))
        assert [t.data_ptr() for t in graph.held[1:]] == [plan, pairs, ticket]
        # the caches make new tensors; the graph's stay as they were
        assert refine._refine_residual_on(dev, b)[-1][1] is not graph.held[2]
        L, M = graph(torch.as_tensor(_spd(b, 2)))
        assert L.shape == M.shape == (b, b)
    finally:
        refine._PANEL_GRAPHS.clear()
        for cache in caches:
            cache.cache_clear()
