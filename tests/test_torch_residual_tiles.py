# tests/test_torch_residual_tiles.py
"""The launch geometry of K4 and K4s (the factorization residual K - L L^T
on the f64 tensor cores, gpmp_tpu_torch.ops.mixed.residual_tiles and
residual_slab_tiles) and of the f32 K9s (the register-tiled slab update on
ops.chol.syrk_tiles), on the CPU.

The kernels run only on a CUDA card (chip_smoke.py phases 2c and 2f hold
them to the plain versions there).  Here: K4's tile list covers every entry
of the lower triangle once, lies inside the matrix and runs the longest k
range first, for odd and even n; K4s's covers its column block once; a
tile-by-tile walk of the plain residual with the kernels' masks and k ranges
(a tile sums over k up to the smaller of its last row and last column)
equals ``factorization_residual_plain`` / ``factorization_residual_slab_plain``
and gpmp_tpu's ``_factorization_residual_f32`` within two f32 spacings of
max|R| (tests/test_torch_mixed.py's bar: both sides compute K - L L^T in
f64, in another order, then round to f32); the f32 walk of K9s over
``syrk_tiles`` matches ``slab_update_plain`` and the JAX per-device update
within 2 b eps32 (|A| + |T||Mt|^T) entrywise (f32 sums of b products in
another order); and the wrappers refuse what the kernels do not take.
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
from gpmp_tpu.ops import mixed as jmixed

from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import chol as ochol
from gpmp_tpu_torch.ops import mixed

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _matern_K(n, seed=0):
    """A noisy Matern-5/2 covariance on uniform points in [0, 1]^3."""
    x = np.random.default_rng(seed).uniform(size=(n, 3))
    D = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) / 0.3
    return (1 + np.sqrt(5) * D + 5 / 3 * D ** 2) * np.exp(-np.sqrt(5) * D) + 1e-2 * np.eye(n)


def _l32(K):
    L32, _ = mixed._f32_preconditioner(torch.as_tensor(K))
    return L32


def _bar(R, ref):
    """max|R - ref| within two f32 spacings of max|ref|."""
    return float(np.max(np.abs(np.asarray(R, dtype=float) - ref))) <= 2 * np.spacing(
        np.float32(np.max(np.abs(ref))))


def _kend(i0, j0, tile, iend, jend):
    return min(min(i0 + tile, iend), min(j0 + tile, jend))


# ---------------------------------------------------------------------------
# the tile lists
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,tile", [(300, 64), (301, 64), (600, 64), (599, 64)])
def test_k4_tiles_cover_the_lower_triangle_longest_first(n, tile):
    tiles = mixed.residual_tiles(n, tile)
    assert tiles.dtype == torch.int32 and tiles.ndim == 2 and tiles.shape[1] == 2
    count = np.zeros((n, n), dtype=np.int16)
    kends = []
    for i0, j0 in tiles.tolist():
        assert 0 <= j0 <= i0 < n and i0 % tile == 0 and j0 % tile == 0
        count[i0:i0 + tile, j0:j0 + tile] += 1
        kends.append(_kend(i0, j0, tile, n, n))
    lower = np.tril(np.ones((n, n), dtype=bool))
    assert np.all(count[lower] == 1) and np.all(count <= 1)
    assert kends == sorted(kends, reverse=True) and kends[0] == n
    nt = -(-n // tile)
    assert len(kends) == nt * (nt + 1) // 2


@pytest.mark.parametrize("n,cut,tile", [(301, 151, 64), (600, 300, 64)])
def test_k4s_tiles_cover_each_column_block(n, cut, tile):
    bounds = (0, cut, n)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for slo, shi in zip(bounds[:-1], bounds[1:]):
            tiles = mixed.residual_slab_tiles(hi - lo, shi - slo, lo, slo, tile)
            count = np.zeros((hi - lo, shi - slo), dtype=np.int16)
            kends = []
            for i0, j0 in tiles.tolist():
                assert lo <= i0 < hi and slo <= j0 < shi
                assert (i0 - lo) % tile == 0 and (j0 - slo) % tile == 0
                count[i0 - lo:i0 - lo + tile, j0 - slo:j0 - slo + tile] += 1
                kends.append(_kend(i0, j0, tile, hi, shi))
            assert np.all(count == 1)
            assert kends == sorted(kends, reverse=True)
    with pytest.raises(ValueError):
        mixed.residual_slab_tiles(0, 10, 0, 0, 64)
    with pytest.raises(ValueError):
        mixed.residual_tiles(10, 0)


@pytest.mark.parametrize("lib_tile", [64, 128])
def test_k4_tile_is_the_built_kernels(lib_tile):
    """The wrappers list tiles of RESIDUAL_TILE only for a build whose
    kernel takes that width (csrc/residual.cu's gpmp_residual_tile)."""

    class Lib:
        def gpmp_residual_tile(self):
            return lib_tile

    if lib_tile == mixed.RESIDUAL_TILE:
        assert mixed._residual_tile(Lib()) == lib_tile
    else:
        with pytest.raises(RuntimeError, match="RESIDUAL_TILE"):
            mixed._residual_tile(Lib())


# ---------------------------------------------------------------------------
# the kernels' walks, in plain torch
# ---------------------------------------------------------------------------
def _k4_walk(K, L32, tile):
    """K4 tile by tile: each listed tile's sum over k < kend in f64, rounded
    to f32, its lower entries written and mirrored; NaN where no tile
    wrote."""
    n = K.shape[0]
    L = L32.double()
    R = torch.full((n, n), float("nan"), dtype=torch.float32)
    for i0, j0 in mixed.residual_tiles(n, tile).tolist():
        i1, j1 = min(i0 + tile, n), min(j0 + tile, n)
        k1 = _kend(i0, j0, tile, n, n)
        blk = (K[i0:i1, j0:j1] - L[i0:i1, :k1] @ L[j0:j1, :k1].T).float()
        low = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
        R[i0:i1, j0:j1] = torch.where(low, blk, R[i0:i1, j0:j1])
        up = R[j0:j1, i0:i1]
        up.copy_(torch.where(low.T, blk.T, up))
    return R


def _k4s_walk(K, L32, bounds, tile):
    """K4s on every slab against every source slab: the (rows, n) f32 slabs
    of R, each column block tile by tile with its k ranges, no mask."""
    L = L32.double()
    n = K.shape[0]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        R = torch.full((hi - lo, n), float("nan"), dtype=torch.float32)
        for slo, shi in zip(bounds[:-1], bounds[1:]):
            for i0, j0 in mixed.residual_slab_tiles(hi - lo, shi - slo, lo, slo, tile).tolist():
                i1, j1 = min(i0 + tile, hi), min(j0 + tile, shi)
                k1 = _kend(i0, j0, tile, hi, shi)
                R[i0 - lo:i1 - lo, j0:j1] = (K[i0:i1, j0:j1]
                                             - L[i0:i1, :k1] @ L[j0:j1, :k1].T).float()
        out.append(R)
    return out


def _jax_residual(K, L32):
    n = K.shape[0]
    return np.asarray(jax.jit(jmixed._factorization_residual_f32, static_argnums=2)(
        K, L32.double().numpy(), jmixed._residual_block(n)))


@pytest.mark.parametrize("n,tile", [(301, 64), (512, 64), (600, 64)])
def test_k4_tile_walk_matches_plain_and_jax(n, tile):
    K = _matern_K(n, n)
    L32 = _l32(K)
    Kt = torch.as_tensor(K)
    walk = _k4_walk(Kt, L32, tile)
    assert not torch.isnan(walk).any() and torch.equal(walk, walk.T)
    plain = mixed.factorization_residual_plain(Kt, L32).numpy()
    ref = _jax_residual(K, L32)
    assert _bar(walk.numpy(), ref) and _bar(plain, ref) and _bar(walk.numpy(), plain)


@pytest.mark.parametrize("n,cut,tile", [(301, 151, 64), (512, 256, 64)])
def test_k4s_tile_walk_matches_plain_and_jax(n, cut, tile):
    K = _matern_K(n, n + 7)
    L32 = _l32(K)
    Kt = torch.as_tensor(K)
    bounds = (0, cut, n)
    walks = _k4s_walk(Kt, L32, bounds, tile)
    ref = _jax_residual(K, L32)
    for (lo, hi), walk in zip(zip(bounds[:-1], bounds[1:]), walks):
        assert not torch.isnan(walk).any()
        plain = torch.empty((hi - lo, n), dtype=torch.float32)
        for slo, shi in zip(bounds[:-1], bounds[1:]):
            mixed.factorization_residual_slab_plain(Kt[lo:hi], L32[lo:hi], L32[slo:shi], slo,
                                                    plain)
        assert _bar(walk.numpy(), ref[lo:hi]) and _bar(plain.numpy(), ref[lo:hi])
    # the two slabs' blocks are each other's transposes, up to the bar
    assert _bar(walks[0][:, cut:].numpy(), walks[1][:, :cut].T.numpy())


def _k9s_f32_walk(A, lo, hi, c0, b, Mt):
    """The f32 K9s over syrk_tiles with the lower-trapezoid mask."""
    n = A.shape[1]
    w0 = c0 + b
    tile = ochol.SYRK_TILE
    Ta = A[:, c0:w0].clone()
    for i0, j0 in ochol.syrk_tiles(n, w0, max(lo, w0), hi).tolist():
        i1, j1 = min(i0 + tile, hi), min(j0 + tile, n)
        C = Ta[i0 - lo:i1 - lo] @ Mt[j0:j1].T
        low = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
        blk = A[i0 - lo:i1 - lo, j0:j1]
        blk.copy_(torch.where(low, blk - C, blk))
    return A


@pytest.mark.parametrize("c0", [0, 256, 384])
def test_k9s_f32_tile_walk_matches_plain_and_jax(c0):
    """R = 2 slabs of n = 600, b = 128 in f32: the panel at 256 straddles
    them."""
    n, b, R = 600, 128, 2
    A = _matern_K(n, 31 + c0).astype(np.float32)
    w0 = c0 + b
    Mt = np.where(np.arange(n)[:, None] >= w0, A[:, c0:w0], 0.0).astype(np.float32)
    upd = jax.jit(lambda k, ml, mt: k[:, w0:] - jax.numpy.dot(
        ml, mt[w0:].T, precision=jax.lax.Precision.HIGHEST))
    for lo in range(0, n, n // R):
        hi = lo + n // R
        r0 = max(lo, w0)
        if r0 >= hi:
            continue
        Mt_t = torch.as_tensor(Mt)
        walk = _k9s_f32_walk(torch.as_tensor(A[lo:hi]).clone(), lo, hi, c0, b, Mt_t).numpy()
        plain = ochol.slab_update_plain(torch.as_tensor(A[lo:hi]).clone(), lo, c0, b,
                                        Mt_t).numpy()
        ref = np.asarray(upd(A[lo:hi], Mt[lo:hi], Mt))
        assert walk.dtype == np.float32 and ref.dtype == np.float32
        low = np.arange(w0, n)[None, :] <= np.arange(lo, hi)[:, None]
        low[:r0 - lo] = False
        S, T = A[lo:hi, w0:].astype(float), A[lo:hi, c0:w0].astype(float)
        scale = 2 * b * EPS32 * (np.abs(S) + np.abs(T) @ np.abs(Mt[w0:].astype(float)).T)
        for out in (walk[:, w0:], plain[:, w0:]):
            assert np.all(np.abs(np.where(low, out, ref) - ref) <= scale)
        assert np.array_equal(np.where(low, A[lo:hi, w0:], walk[:, w0:]), A[lo:hi, w0:])
        assert np.array_equal(walk[:, :w0], A[lo:hi, :w0])


def test_k4_wrappers_refuse():
    """CPU tensors to the *_cuda entries, wrong dtypes, non-contiguous or
    mis-shaped tensors: each raises, none falls back."""
    K = torch.as_tensor(_matern_K(128, 1))
    L32 = _l32(K.numpy())
    R = torch.empty((128, 128), dtype=torch.float32)
    cases = [
        (lambda: mixed.factorization_residual_cuda(K, L32), "CUDA"),
        (lambda: mixed.factorization_residual_slab_cuda(K, L32, L32, 0, 0, R), "CUDA"),
        (lambda: ochol.slab_update_cuda(K.float(), 0, 0, 64, K[:, :64].float().contiguous()),
         "CUDA"),
        (lambda: mixed.factorization_residual_cuda(K, L32.double()), "CUDA|dtype"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    # the dispatchers take the plain versions on the CPU and count no launch
    before = (mixed.K4_LAUNCHES, mixed.K4S_LAUNCHES, ochol.K9S_F32_LAUNCHES)
    mixed.factorization_residual(K, L32)
    mixed.factorization_residual_slab(K, L32, L32, 0, 0, R)
    ochol.slab_update(K.float().clone(), 0, 0, 64, K[:, :64].float().contiguous())
    assert (mixed.K4_LAUNCHES, mixed.K4S_LAUNCHES, ochol.K9S_F32_LAUNCHES) == before
