# tests/test_torch_streamed_tiles.py
"""The launch geometry of the streamed engine's K10r (the factorization
residual K - L L^T on the f64 tensor-core core, from the f32 pair and from
f64 column panels) and K10m (the residual B - (K32 + E32) X against the
pair), on the CPU.

The kernels run only on a CUDA card (chip_smoke.py phase 2d holds them to
their plain versions there).  Here:

- ``mixed.residual_panel_tiles`` covers every lower entry of a panel's
  columns [c0, c0 + w) exactly once, lies inside it and runs the longest k
  range first, for ragged n, w and c0;
- a tile-by-tile walk of K10r's two modes (the kernel's tiles, its i >= j
  mask, its k range cut at the tile's last row or column, its mirror), each
  entry's products summed in one order over k whatever the tile (as the
  kernel's fragments do), is within 1e-14 of max|K| of K - L L^T in f64
  before the f32 rounding; rounded, it is within one f32 rounding (two f32
  spacings of max|R|, tests/test_torch_streamed.py's bar) of
  ``streamed_residual_ff_plain``, ``residual_panel_plain`` and gpmp_tpu's
  ``_streamed_residual_f32``, exactly symmetric, and bitwise K4's walk on
  hi + lo in f64, from the pair and from every panel width;
- a walk of K10m's blocking (32 rows a block, 4 a warp, lane t on columns
  128 s + 4 t .. + 3, a butterfly over the lanes, the warps in order, K3's
  fixed-order second pass) is within 1e-13 relative of ``ff_residual_plain``
  and gpmp_tpu's ``_matvec_ff`` residual (f64 sums of the same products in
  another order);
- the wrappers refuse wrong devices, dtypes, shapes and k > 8, and hand the
  kernels the tile lists above.
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
import gpmp_tpu.parallel.streamed as jst

from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import mixed
from gpmp_tpu_torch.ops import streamed as ops

TILE = mixed.RESIDUAL_TILE
FF_WARPS, FF_ROWS, FF_STEP = 8, 4, 128  # K10m's block: csrc/mixed.cu


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _pair(n, seed):
    """(K64, K32, E32, L32): a noisy Matern-5/2 covariance, its f32 pair
    (K64 = hi + lo exactly) and its f32 factor."""
    x = np.random.default_rng(seed).uniform(size=(n, 3))
    D = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) / 0.3
    K = (1 + np.sqrt(5) * D + 5 / 3 * D ** 2) * np.exp(-np.sqrt(5) * D) + 1e-2 * np.eye(n)
    K32 = torch.as_tensor(K.astype(np.float32))
    E32 = torch.as_tensor((K - K.astype(np.float32).astype(np.float64)).astype(np.float32))
    K64 = K32.double() + E32.double()
    L32, _ = mixed._f32_preconditioner(K64)
    return K64, K32, E32, L32


def _kend(i0, j0, tile, iend, jend):
    return min(min(i0 + tile, iend), min(j0 + tile, jend))


def _panels(n, w):
    return [(c0, min(w, n - c0)) for c0 in range(0, n, w)]


# ---------------------------------------------------------------------------
# the panel tile lists
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,c0,w", [(300, 0, 300), (301, 0, 97), (301, 97, 97),
                                    (301, 291, 10), (257, 100, 157), (600, 37, 200)])
def test_k10r_panel_tiles_cover_the_panel_longest_first(n, c0, w):
    tiles = mixed.residual_panel_tiles(n, c0, w, TILE)
    assert tiles.dtype == torch.int32 and tiles.ndim == 2 and tiles.shape[1] == 2
    count = np.zeros((n, n), dtype=np.int16)
    kends = []
    for i0, j0 in tiles.tolist():
        assert c0 <= j0 <= i0 < n and j0 < c0 + w
        assert (i0 - c0) % TILE == 0 and (j0 - c0) % TILE == 0
        count[i0:i0 + TILE, j0:min(j0 + TILE, c0 + w)] += 1
        kends.append(_kend(i0, j0, TILE, n, c0 + w))
    lower = np.tril(np.ones((n, n), dtype=bool))
    cols = np.zeros((n, n), dtype=bool)
    cols[c0:, c0:c0 + w] = True
    assert np.all(count[lower & cols] == 1) and np.all(count <= 1)
    assert not count[~cols].any()
    assert kends == sorted(kends, reverse=True) and kends[0] == min(n, c0 + w)


@pytest.mark.parametrize("n,w", [(301, 97), (600, 512), (257, 64)])
def test_k10r_panels_cover_the_lower_triangle_once(n, w):
    count = np.zeros((n, n), dtype=np.int16)
    for c0, cw in _panels(n, w):
        for i0, j0 in mixed.residual_panel_tiles(n, c0, cw, TILE).tolist():
            blk = np.zeros((n, n), dtype=bool)
            blk[i0:i0 + TILE, j0:min(j0 + TILE, c0 + cw)] = True
            count[blk & np.tril(np.ones((n, n), dtype=bool))] += 1
    assert np.all(count[np.tril(np.ones((n, n), dtype=bool))] == 1)
    with pytest.raises(ValueError):
        mixed.residual_panel_tiles(n, n - 5, 6, TILE)
    with pytest.raises(ValueError):
        mixed.residual_panel_tiles(n, 0, 0, TILE)


# ---------------------------------------------------------------------------
# K10r's walks, in plain torch
# ---------------------------------------------------------------------------
def _walk(S, L32, tiles, jend, R64, R32):
    """The kernel over one tile list: C = sum_{k < kend} L[i, k] L[j, k],
    summed over k in order (the same order for an entry whatever its tile;
    the products past its own k range are exact zeros), R = S(i, j) - C on
    the entries i >= j, j < jend, in f64 (R64) and rounded once to f32
    (R32), each mirrored to (j, i)."""
    n = L32.shape[0]
    L = L32.double()
    for i0, j0 in tiles.tolist():
        i1, j1 = min(i0 + TILE, n), min(j0 + TILE, jend)
        C = torch.zeros((i1 - i0, j1 - j0), dtype=torch.float64)
        for k in range(_kend(i0, j0, TILE, n, jend)):
            C += L[i0:i1, k, None] * L[None, j0:j1, k]
        blk = S(i0, i1, j0, j1) - C
        low = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
        for R, v in ((R64, blk), (R32, blk.float())):
            R[i0:i1, j0:j1] = torch.where(low, v, R[i0:i1, j0:j1])
            up = R[j0:j1, i0:i1]
            up.copy_(torch.where(low.T, v.T, up))


def _nan(n, dtype):
    return torch.full((n, n), float("nan"), dtype=dtype)


def _k4_walk(K64, L32):
    n = K64.shape[0]
    R64, R32 = _nan(n, torch.float64), _nan(n, torch.float32)
    _walk(lambda i0, i1, j0, j1: K64[i0:i1, j0:j1], L32, mixed.residual_tiles(n, TILE), n,
          R64, R32)
    return R64, R32


def _pair_walk(K32, E32, L32):
    n = K32.shape[0]
    R64, R32 = _nan(n, torch.float64), _nan(n, torch.float32)
    _walk(lambda i0, i1, j0, j1: K32[i0:i1, j0:j1].double() + E32[i0:i1, j0:j1].double(),
          L32, mixed.residual_tiles(n, TILE), n, R64, R32)
    return R64, R32


def _panel_walk(K64, L32, w):
    n = K64.shape[0]
    R64, R32 = _nan(n, torch.float64), _nan(n, torch.float32)
    for c0, cw in _panels(n, w):
        P = K64[c0:, c0:c0 + cw].contiguous()  # what the kernel reads: P[i - c0, j - c0]
        _walk(lambda i0, i1, j0, j1, P=P, c0=c0: P[i0 - c0:i1 - c0, j0 - c0:j1 - c0], L32,
              mixed.residual_panel_tiles(n, c0, cw, TILE), c0 + cw, R64, R32)
    return R64, R32


def _bar(R, ref):
    """max|R - ref| within two f32 spacings of max|ref|."""
    ref = np.asarray(ref, dtype=float)
    return float(np.max(np.abs(np.asarray(R, dtype=float) - ref))) <= 2 * np.spacing(
        np.float32(np.max(np.abs(ref))))


@pytest.mark.parametrize("n,jax_block", [(300, 100), (257, 257)])
def test_k10r_walks_match_plain_jax_and_k4(n, jax_block):
    K64, K32, E32, L32 = _pair(n, n)
    L = L32.double()
    exact = K64 - L @ L.T
    scale = float(K64.abs().max())
    k4_64, k4_32 = _k4_walk(K64, L32)
    pair_64, pair_32 = _pair_walk(K32, E32, L32)
    Rj = np.asarray(jax.jit(lambda K_, L_: jst._streamed_residual_f32(
        lambda c0, w: K_[c0:, c0:c0 + w], L_, n, jax_block, jax_block))(
            K64.numpy(), L32.numpy()))
    plain_ff = ops.streamed_residual_ff_plain(K32, E32, L32, 128)
    for R64, R32 in ((pair_64, pair_32),) + tuple(_panel_walk(K64, L32, w)
                                                  for w in (64, 97, 100, 128, n)):
        assert not torch.isnan(R32).any() and torch.equal(R32, R32.T)
        assert float((R64 - exact).abs().max()) <= 1e-14 * scale
        assert torch.equal(R32, k4_32) and torch.equal(R64, k4_64)
        assert _bar(R32.numpy(), Rj) and _bar(R32.numpy(), plain_ff.numpy())
    for w in (97, 128):
        plain_panels = torch.empty((n, n), dtype=torch.float32)
        for c0, cw in _panels(n, w):
            ops.residual_panel_plain(K64[c0:, c0:c0 + cw].contiguous(), L32, c0, plain_panels)
        assert _bar(pair_32.numpy(), plain_panels.numpy())


# ---------------------------------------------------------------------------
# K10m's walk
# ---------------------------------------------------------------------------
def _butterfly(v):
    """__shfl_xor_sync's tree over the last axis (32 lanes): every lane ends
    with the same sum; lane 0's is returned."""
    for m in (16, 8, 4, 2, 1):
        v = v + v[..., torch.arange(32) ^ m]
    return v[..., 0]


def _reduce_pairs(partial):
    """csrc/mixed.cu reduce_pairs_kernel: 256 threads sum the partials
    t, t + 256, ... in order, then a tree over the threads."""
    s = torch.zeros((256, 2), dtype=torch.float64)
    for i in range(partial.shape[0]):
        s[i % 256] += partial[i]
    h = 128
    while h:
        s[:h] = s[:h] + s[h:2 * h]
        h //= 2
    return s[0]


def _k10m_walk(K32, E32, X, B):
    n, k = X.shape
    Kp = K32.double() + E32.double()  # the kernel's hi + lo, exact in f64
    acc = torch.zeros((n, 32, k), dtype=torch.float64)  # a row's 32 lanes
    lanes = torch.arange(32)
    for s0 in range(0, n, FF_STEP):
        for e in range(4):
            cols = s0 + 4 * lanes + e
            ok = cols < n
            c = torch.where(ok, cols, 0)
            acc += torch.where(ok[None, :, None], Kp[:, c, None] * X[c][None], 0.0)
    R = B - _butterfly(acc.transpose(1, 2))
    rows_per_block = FF_WARPS * FF_ROWS
    nb = -(-n // rows_per_block)
    partial = torch.zeros((nb, 2), dtype=torch.float64)
    for b in range(nb):
        for w in range(FF_WARPS):
            rr = bb = torch.zeros((), dtype=torch.float64)
            for r in range(FF_ROWS):
                i = b * rows_per_block + w * FF_ROWS + r
                if i < n:
                    for q in range(k):
                        rr = rr + R[i, q] * R[i, q]
                        bb = bb + B[i, q] * B[i, q]
            partial[b] += torch.stack([rr, bb])
    return R, _reduce_pairs(partial)


@pytest.mark.parametrize("n,k", [(300, 2), (301, 3), (257, 8), (512, 1)])
def test_k10m_walk_matches_plain_and_jax(n, k):
    _K64, K32, E32, _L32 = _pair(n, n + 1)
    rng = np.random.default_rng(n + k)
    X, B = torch.as_tensor(rng.normal(size=(n, k))), torch.as_tensor(rng.normal(size=(n, k)))
    R, norms = _k10m_walk(K32, E32, X, B)
    Rp, norms_p = ops.ff_residual_plain(K32, E32, X, B)
    Rj = np.asarray(jax.jit(lambda K_, E_, X_, B_: B_ - jst._matvec_ff(K_, E_, X_))(
        K32.numpy(), E32.numpy(), X.numpy(), B.numpy()))
    for ref, ref_norms in ((Rp.numpy(), norms_p.numpy()),
                           (Rj, [np.sum(Rj ** 2), np.sum(B.numpy() ** 2)])):
        assert np.max(np.abs(R.numpy() - ref)) <= 1e-13 * np.max(np.abs(ref))
        np.testing.assert_allclose(norms.numpy(), ref_norms, rtol=1e-13)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
class _Lib:
    """Stands in for the built library: records which entry each launch
    called; the kernels' geometry constants as csrc/ gives them."""

    def gpmp_residual_tile(self):
        return TILE

    def gpmp_ff_residual_blocks(self, n):
        return -(-n // (FF_WARPS * FF_ROWS))

    def __getattr__(self, name):
        return name


def test_k10r_k10m_wrappers_refuse_and_launch(monkeypatch):
    """On CPU tensors the *_cuda entries raise and the dispatchers take the
    plain versions, counting no launch.  With the tensors taken for CUDA
    ones (is_cuda patched, the library and the launch stood in for), wrong
    dtypes, shapes, contiguity and k > 8 raise, and a good call launches the
    right entry once with the tiles above."""
    n = 200
    _K64, K32, E32, L32 = _pair(n, 5)
    P = _K64[64:, 64:164].contiguous()
    R = torch.empty((n, n), dtype=torch.float32)
    X = torch.ones((n, 2), dtype=torch.float64)
    for call in (lambda: ops.streamed_residual_ff_cuda(K32, E32, L32),
                 lambda: ops.residual_panel_cuda(P, L32, 64, R),
                 lambda: ops.ff_residual_cuda(K32, E32, X, X)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    before = (ops.K10R_LAUNCHES, ops.K10M_LAUNCHES)
    ops.streamed_residual_ff(K32, E32, L32, 64)
    ops.residual_panel(P, L32, 64, R)
    ops.ff_residual(K32, E32, X, X)
    assert (ops.K10R_LAUNCHES, ops.K10M_LAUNCHES) == before

    launched = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(ops._build, "load", lambda: _Lib())
    monkeypatch.setattr(ops._build, "launch",
                        lambda name, fn, dev, *args: launched.append((fn, args)))
    bad = [
        lambda: ops.streamed_residual_ff_cuda(K32.double(), E32, L32),
        lambda: ops.streamed_residual_ff_cuda(K32, E32[:-1], L32),
        lambda: ops.streamed_residual_ff_cuda(K32, E32, L32[:, :-1]),
        lambda: ops.streamed_residual_ff_cuda(K32.T, E32, L32),
        lambda: ops.residual_panel_cuda(P.float(), L32, 64, R),
        lambda: ops.residual_panel_cuda(P[1:], L32, 64, R),
        lambda: ops.residual_panel_cuda(P, L32, 150, R),
        lambda: ops.residual_panel_cuda(_K64[64:, 64:164], L32, 64, R),
        lambda: ops.ff_residual_cuda(K32, E32, torch.ones((n, 9), dtype=torch.float64),
                                     torch.ones((n, 9), dtype=torch.float64)),
        lambda: ops.ff_residual_cuda(K32, E32, X.float(), X),
        lambda: ops.ff_residual_cuda(K32, E32, X, X[:, :1]),
        lambda: ops.ff_residual_cuda(K32, E32[:-1, :-1], X, X),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert not launched and (ops.K10R_LAUNCHES, ops.K10M_LAUNCHES) == before

    ops.streamed_residual_ff_cuda(K32, E32, L32)
    ops.residual_panel_cuda(P, L32, 64, R)
    ops.ff_residual(K32, E32, torch.ones((n, 10), dtype=torch.float64),
                    torch.ones((n, 10), dtype=torch.float64))
    assert [fn for fn, _ in launched] == ["gpmp_streamed_residual_ff",
                                          "gpmp_streamed_residual_panel",
                                          "gpmp_ff_residual", "gpmp_ff_residual"]
    (_, ff), (_, panel), (_, m8), (_, m2) = launched
    cpu = torch.device("cpu")
    ff_tiles = mixed._residual_tiles_on(cpu, n, TILE)
    panel_tiles = mixed._residual_panel_tiles_on(cpu, n, 64, 100, TILE)
    assert torch.equal(ff_tiles, mixed.residual_tiles(n, TILE))
    assert torch.equal(panel_tiles, mixed.residual_panel_tiles(n, 64, 100, TILE))
    assert ff[4:] == (ff_tiles.data_ptr(), ff_tiles.shape[0], n)
    assert panel[3:] == (panel_tiles.data_ptr(), panel_tiles.shape[0], n, 64, 100)
    assert (m8[-2:], m2[-2:]) == ((n, 8), (n, 2))
    assert (ops.K10R_LAUNCHES, ops.K10M_LAUNCHES) == (before[0] + 2, before[1] + 2)
