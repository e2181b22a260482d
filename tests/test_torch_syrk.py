# tests/test_torch_syrk.py
"""The launch geometry of K9u and K9s (f64), the f64 tensor-core trailing
update of the port's blocked Cholesky (gpmp_tpu_torch.ops.chol.syrk_tiles,
the tile list the wrappers hand to csrc/syrk.cu), on the CPU.

The kernel runs only on a CUDA card (chip_smoke.py phases 2e and 2f hold it
to the plain versions there).  Here: every entry of the trailing block's
lower triangle (K9u) or of a slab's lower trapezoid (K9s) lies in exactly
one listed tile, no listed tile lies wholly above the diagonal or outside
the block, the last panels included; a tile-by-tile walk of the plain
update over the list, with the kernel's entrywise masks, equals
``trailing_update_plain`` / ``slab_update_plain`` and gpmp_tpu's update
(``S - T T^T``; the per-device ``K_loc[:, w0:] - Mt_loc Mt_all[w0:]^T``)
within 8 b eps64 (|S| + |T||T|^T) entrywise (f64 sums of b products in
another order: test_k9u_plain_matches_jax's tolerance); and the wrappers
refuse what the kernel does not take.
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)

from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import chol as ops

EPS64 = float(np.finfo(np.float64).eps)
TILE = ops.SYRK_TILE


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _matern_K(n, seed=0):
    """A noisy Matern-5/2 covariance on uniform points in [0, 1]^3."""
    x = np.random.default_rng(seed).uniform(size=(n, 3))
    D = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) / 0.3
    return (1 + np.sqrt(5) * D + 5 / 3 * D ** 2) * np.exp(-np.sqrt(5) * D) + 1e-2 * np.eye(n)


def _check_cover(n, w0, r0, iend):
    """Every entry (i, j) of rows [r0, iend) x columns [w0, n) with j <= i in
    exactly one listed tile; each tile on the grid from (r0, w0), inside the
    block and meeting its lower part."""
    tiles = ops.syrk_tiles(n, w0, r0, iend)
    assert tiles.dtype == torch.int32 and tiles.ndim == 2 and tiles.shape[1] == 2
    count = np.zeros((iend - r0, n - w0), dtype=np.int16)
    for i0, j0 in tiles.tolist():
        assert r0 <= i0 < iend and w0 <= j0 < n
        assert (i0 - r0) % TILE == 0 and (j0 - w0) % TILE == 0
        assert j0 <= min(i0 + TILE, iend) - 1, "a tile wholly above the diagonal"
        count[i0 - r0:i0 - r0 + TILE, j0 - w0:j0 - w0 + TILE] += 1
    gi = np.arange(r0, iend)[:, None]
    gj = np.arange(w0, n)[None, :]
    lower = gj <= gi
    assert np.all(count[lower] == 1)
    assert np.all(count <= 1)
    return tiles


@pytest.mark.parametrize("n", [1000, 4099])
def test_k9u_tiles_cover_every_panel(n):
    b = 512
    for c0 in range(0, n - b, b):  # every panel that leaves a trailing block
        off = c0 + b
        tiles = _check_cover(n, off, off, n)
        if n - off < TILE:  # the last panel: 3 rows at n = 4099
            assert tiles.tolist() == [[off, off]]


@pytest.mark.parametrize("n,bounds,b", [(4099, (0, 2050, 4099), 512),
                                        (1000, (0, 500, 1000), 100)])
def test_k9s_tiles_cover_the_trapezoid(n, bounds, b):
    panels = (0, 1024, 1792, 3584) if n == 4099 else range(0, n - b, b)
    seen = 0
    for c0 in panels:
        w0 = c0 + b
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            r0 = max(lo, w0)
            if r0 >= hi:
                with pytest.raises(ValueError, match="trailing"):
                    ops.syrk_tiles(n, w0, r0, hi)
                continue
            _check_cover(n, w0, r0, hi)
            seen += 1
    assert seen >= 4


def _walk(A, tiles, off, iend, c0, b, Tb, mirror):
    """The kernel's update, tile by tile with its masks, in plain torch: A
    holds global rows [off, iend); Tb's row j is the right operand's row."""
    n = A.shape[1]
    Ta = A[:, c0:c0 + b]
    for i0, j0 in tiles.tolist():
        i1, j1 = min(i0 + TILE, iend), min(j0 + TILE, n)
        C = Ta[i0 - off:i1 - off] @ Tb[j0:j1].T
        gi = torch.arange(i0, i1)[:, None]
        gj = torch.arange(j0, j1)[None, :]
        low = gj <= gi
        blk = A[i0 - off:i1 - off, j0:j1]
        new = torch.where(low, blk - C, blk)
        blk.copy_(new)
        if mirror:
            up = A[j0:j1, i0:i1]
            up.copy_(torch.where((gj < gi).T, new.T, up))
    return A


def _held(out, ref, S, T, Tb, b):
    scale = np.abs(S) + np.abs(T) @ np.abs(Tb).T
    return bool(np.all(np.abs(out - ref) <= 8 * b * EPS64 * scale))


@pytest.mark.parametrize("n,b,c0", [(1000, 128, 0), (1000, 128, 768), (643, 128, 512)])
def test_k9u_tile_walk_matches_plain_and_jax(n, b, c0):
    A = _matern_K(n, n + c0)
    off = c0 + b
    tiles = ops.syrk_tiles(n, off, off, n)
    T = A[off:, c0:off]
    walk = _walk(torch.as_tensor(A).clone(), tiles, 0, n, c0, b,
                 torch.as_tensor(A)[:, c0:off], True).numpy()
    plain = ops.trailing_update_plain(torch.as_tensor(A).clone(), c0, b).numpy()
    ref = np.asarray(jax.jit(lambda s, t: s - t @ t.T)(A[off:, off:], T))
    for out in (walk[off:, off:], plain[off:, off:]):
        assert _held(out, ref, A[off:, off:], T, T, b)
    assert _held(walk[off:, off:], plain[off:, off:], A[off:, off:], T, T, b)
    assert np.array_equal(walk[off:, off:], walk[off:, off:].T)
    assert np.array_equal(walk[:off], A[:off]) and np.array_equal(walk[:, :off], A[:, :off])


@pytest.mark.parametrize("c0", [0, 400, 600])
def test_k9s_tile_walk_matches_plain_and_jax(c0):
    """R = 2 slabs of n = 1000, b = 200: the panel at 400 straddles them."""
    n, b, R = 1000, 200, 2
    A = _matern_K(n, 11 + c0)
    w0 = c0 + b
    grow = np.arange(n)[:, None]
    Mt = np.where(grow >= w0, A[:, c0:w0], 0.0)  # the gathered trailing panel rows
    upd = jax.jit(lambda k, ml, mt: k[:, w0:] - ml @ mt[w0:].T)
    for lo in range(0, n, n // R):
        hi = lo + n // R
        r0 = max(lo, w0)
        if r0 >= hi:
            continue
        tiles = ops.syrk_tiles(n, w0, r0, hi)
        walk = _walk(torch.as_tensor(A[lo:hi]).clone(), tiles, lo, hi, c0, b,
                     torch.as_tensor(Mt), False).numpy()
        plain = ops.slab_update_plain(torch.as_tensor(A[lo:hi]).clone(), lo, c0, b,
                                      torch.as_tensor(Mt)).numpy()
        ref = np.asarray(upd(A[lo:hi], Mt[lo:hi], Mt))  # JAX: the whole slab's columns w0:
        low = np.arange(w0, n)[None, :] <= np.arange(lo, hi)[:, None]
        low[:r0 - lo] = False
        S, T = A[lo:hi, w0:], A[lo:hi, c0:w0]
        for out in (walk[:, w0:], plain[:, w0:]):
            assert _held(np.where(low, out, ref), ref, S, T, Mt[w0:], b)
        assert np.array_equal(np.where(low, A[lo:hi, w0:], walk[:, w0:]), A[lo:hi, w0:])
        assert np.array_equal(walk[:, :w0], A[lo:hi, :w0])


def test_k9_wrappers_refuse():
    """CPU tensors to the *_cuda entries, f32 for K9u, a non-contiguous A, a
    wrong Mt shape: each raises, none falls back."""
    A = torch.as_tensor(_matern_K(256, 1))
    Mt = torch.zeros((256, 64), dtype=torch.float64)
    cases = [
        (lambda: ops.trailing_update_cuda(A.clone(), 0, 64), "CUDA"),
        (lambda: ops.trailing_update_probe(A.clone(), 0, 64, 8), "CUDA"),
        (lambda: ops.slab_update_cuda(A.clone(), 0, 0, 64, Mt), "CUDA"),
        (lambda: ops.slab_update_cuda(A.float(), 0, 0, 64, Mt.float()), "CUDA"),
        (lambda: ops.trailing_update_cuda(A.float(), 0, 64), "dtype"),
        (lambda: ops.trailing_update_cuda(A.T, 0, 64), "contiguous"),
        (lambda: ops.slab_update_cuda(A[:, :200], 0, 0, 64, Mt), "contiguous"),
        (lambda: ops.slab_update_cuda(A.clone(), 0, 0, 64, Mt[:, :32].clone()), "Mt must be"),
        (lambda: ops.slab_update_cuda(A.clone(), 0, 0, 64, Mt.float()), "dtype"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
