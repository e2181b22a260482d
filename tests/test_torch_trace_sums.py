# tests/test_torch_trace_sums.py
"""The two trace-sum kernels of the port, on the CPU: K10t (the streamed
engine's chunked trace sums, gpmp_tpu_torch.ops.streamed) and K7 (the mixed
logdet's trace series, gpmp_tpu_torch.ops.mixed).

The kernels run only on a CUDA card (chip_smoke.py phases 2b, 2d and 2f hold
them to their plain versions there).  Here their geometry and their order of
sums, which the wrappers' plans (``h_traces_plan``, ``trace_sums_plan``)
fix:

- coverage: K10t's persistent grid, block b walking the tiles b, b + blocks,
  ... of 32 chunk rows x 128 columns, a thread 4 rows x 4 columns of each,
  visits every (a, m) entry of a chunk exactly once; K7's grid-stride pass
  over 16-byte groups visits every entry of a slab, and its diagonal loop
  every row, exactly once.  Ragged c and n, n % 4 != 0, c under a tile,
  the H100's plans at the engines' shapes;
- walk vs plain: a walk in each kernel's fixed order (a thread's entries in
  order, csrc/fixed_sum.cuh's butterfly over the lanes, the warps in order,
  then the last block's sum over the block partials) is within 1e-12 of
  ``h_traces_chunk_plain`` / ``trace_sums_plain`` and ``series_sums_plain``
  over the sums of the absolute terms (f64 sums of exact products of f32
  values, in another order), on slabs too, including views whose base is
  not 16-byte aligned (the kernel's scalar-load instance sums in the same
  order);
- walk vs JAX: within 1e-12 of gpmp_tpu's ``_h_traces`` (jax.jit, n = 256,
  fed the chunk products H[r0:r0+c] H that XLA computes there) and of the
  mixed logdet's traces as gpmp_tpu.ops.mixed writes them;
- the ``*_cuda`` wrappers refuse CPU tensors, wrong dtypes and shapes, and
  hand their kernel the plan's blocks.

About 4 s on the CPU with its imports (torch on 2 threads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
import gpmp_tpu.parallel.streamed as jst

from _fixed_sum_walk import grid_sum as _grid_sum
from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import mixed
from gpmp_tpu_torch.ops import streamed as ops

H100_SMS = 132  # the card's SM count, as the wrappers read it there
THREADS = 256   # both kernels' blocks (csrc/streamed.cu, csrc/mixed.cu)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _h(n, seed, scale=1e-3):
    """A defect-like f32 H: symmetric up to f32 roundoff, with one entry
    made asymmetric (Hc^T is not Hr)."""
    rng = np.random.default_rng(seed)
    A = scale * rng.normal(size=(n, n))
    H = (A + A.T).astype(np.float32)
    H[min(3, n - 1), min(5, n - 1)] += np.float32(scale * 1e-3)
    return H


def _err(walk, plain, scale):
    return float(np.max(np.abs(np.asarray(walk) - np.asarray(plain)) / np.maximum(scale, 1e-300)))


# ---------------------------------------------------------------------------
# K10t
# ---------------------------------------------------------------------------
def _k10t_tiles(X, ta, tm):
    """A padded (ta 32, tm 128) array as the kernel cuts it: [tile t =
    a-tile + ta m-tile, warp w, lane l, row r, column e] holds the entry
    (32 (t % ta) + 4 w + r, 128 (t // ta) + 4 l + e)."""
    T = X.reshape(ta, ops.H_TRACES_ROWS // 4, 4, tm, 32, 4)
    return T.transpose(3, 0, 1, 4, 2, 5).reshape(ta * tm, ops.H_TRACES_ROWS // 4, 32, 4, 4)


def _k10t_walk(H, H2r, r0, sms=H100_SMS):
    """K10t's four sums of the chunk [r0, r0 + c) in the kernel's order, and
    how many times its walk visits each entry of the (c, n) chunk."""
    c, n = H2r.shape
    ta, tm, blocks = ops.h_traces_plan(c, n, sms)
    rows, cols = ta * ops.H_TRACES_ROWS, tm * ops.H_TRACES_COLS

    def padded(A, dtype=np.float64):
        P = np.zeros((rows, cols), dtype=dtype)
        P[:c, :n] = A
        return P

    idx = np.arange(c)
    diag = np.zeros((c, n), dtype=bool)
    diag[idx, r0 + idx] = True
    X, Y, Z, D, E = (_k10t_tiles(padded(A, dt), ta, tm) for A, dt in (
        (H[r0:r0 + c], np.float64), (H2r, np.float64), (H[:, r0:r0 + c].T, np.float64),
        (diag, bool), (np.arange(c * n).reshape(c, n) + 1, np.int64)))
    tiles = ta * tm
    s = np.zeros((blocks, ops.H_TRACES_ROWS // 4, 32, 4))
    count = np.zeros(c * n + 1, dtype=np.int64)  # entry e + 1 (0: the padding)
    for k in range(-(-tiles // blocks)):  # block b's k-th tile: b + k blocks
        t = np.arange(blocks) + k * blocks
        live = (t < tiles)[:, None, None]
        t = np.minimum(t, tiles - 1)
        np.add.at(count, E[t][live[:, 0, 0]].ravel(), 1)
        for r in range(4):
            for e in range(4):
                x, y, z = X[t, :, :, r, e], Y[t, :, :, r, e], Z[t, :, :, r, e]
                s[..., 0] += np.where(live & D[t, :, :, r, e], x, 0.0)
                s[..., 1] += np.where(live, x * z, 0.0)
                s[..., 2] += np.where(live, y * z, 0.0)
                s[..., 3] += np.where(live, y * y, 0.0)
    return _grid_sum(s.reshape(blocks, THREADS, 4)), count[1:].reshape(c, n)


def _k10t_plain(H, H2r, r0):
    acc = torch.zeros(4, dtype=torch.float64)
    ops.h_traces_chunk_plain(torch.as_tensor(H), torch.as_tensor(H2r), r0, acc)
    return acc.numpy()


@pytest.mark.parametrize("c,n,plan", [(512, 32768, (16, 256, 264)), (512, 51200, (16, 400, 264)),
                                      (512, 1000, (16, 8, 128)), (8, 8192, (1, 64, 64))])
def test_k10t_plan_at_the_engines_shapes(c, n, plan):
    assert ops.h_traces_plan(c, n, H100_SMS) == plan
    ta, tm, blocks = plan
    assert blocks <= ops.H_TRACES_BLOCKS_PER_SM * H100_SMS and blocks <= ta * tm
    with pytest.raises(ValueError):
        ops.h_traces_plan(n + 1, n, H100_SMS)


@pytest.mark.parametrize("c,n,r0", [(64, 256, 0), (64, 256, 192), (33, 130, 97), (5, 7, 2),
                                    (1, 1, 0), (40, 301, 261), (100, 257, 100)])
def test_k10t_walk_covers_the_chunk_and_matches_plain(c, n, r0):
    """Ragged c and n, n % 4 != 0, r0 % 4 != 0, c under a tile; a small grid
    (7 SMs) so that blocks walk several tiles."""
    H = _h(n, 10 * n + c)
    H2r = (H[r0:r0 + c] @ H).astype(np.float32)
    Habs = np.abs(H)
    scale = _k10t_plain(Habs, np.abs(H2r), r0)
    plain = _k10t_plain(H, H2r, r0)
    for sms in (H100_SMS, 7):
        walk, count = _k10t_walk(H, H2r, r0, sms)
        assert np.all(count == 1)
        assert _err(walk, plain, scale) <= 1e-12


def test_k10t_walk_matches_jax():
    """Every row chunk of H, summed as gpmp_tpu's _h_traces (jax.jit) sums
    them, from the chunk products XLA computes there."""
    n, chunk = 256, 64
    H = _h(n, 4)
    hp = jax.lax.Precision.HIGHEST
    ref = np.array(jax.jit(lambda H_: jst._h_traces(H_, chunk))(H))
    H2 = np.asarray(jax.jit(lambda H_: jnp.dot(H_, H_, precision=hp))(H))
    Habs = np.abs(H)
    walk, scale = np.zeros(4), np.zeros(4)
    for r0 in range(0, n, chunk):
        walk += _k10t_walk(H, H2[r0:r0 + chunk], r0)[0]
        scale += _k10t_plain(Habs, np.abs(H2[r0:r0 + chunk]), r0)
    assert _err(walk, ref, scale) <= 1e-12
    # the engine's dispatch on the CPU: the plain version over its chunks
    from gpmp_tpu_torch.parallel import streamed as st
    got = st._h_traces(torch.as_tensor(H), chunk).numpy()
    assert _err(got[:2], ref[:2], scale[:2]) <= 1e-12


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------
def _k7_walk(A, B=None, off=0, sms=H100_SMS):
    """K7 in the kernel's order: trace_sums (B None) [sum_i A[i, off + i],
    sum A^2], series_sums [sum B o A, sum B^2]; and how many times its pass
    visits each 16-byte group of the flat slab, and its diagonal loop each
    row.  Thread j's steps start at the groups j + k U S (S the grid's
    threads, U = TRACE_SUMS_UNROLL), each step taking j + k U S + u S,
    u < U, those past the end skipped."""
    rows, n = A.shape
    blocks = mixed.trace_sums_plan(rows, n, sms)
    S, U, total = blocks * THREADS, mixed.TRACE_SUMS_UNROLL, rows * n
    groups = -(-total // 4)

    def grouped(X):  # [g, e]: entry 4 g + e, zeros past the end
        flat = np.zeros(groups * 4)
        flat[:total] = np.asarray(X, dtype=np.float64).ravel()
        return flat.reshape(groups, 4)

    a = grouped(A)
    b = grouped(B) if B is not None else None
    count = np.zeros(groups, dtype=np.int64)
    s = np.zeros((S, 2))
    j = np.arange(S)
    for g0 in range(0, groups, U * S):
        for u in range(U):
            g = g0 + j + u * S
            live = g < groups
            gc = np.minimum(g, groups - 1)
            np.add.at(count, g[live], 1)
            for e in range(4):
                x = np.where(live, a[gc, e], 0.0)
                if b is None:
                    s[:, 1] += x * x
                else:
                    y = np.where(live, b[gc, e], 0.0)
                    s[:, 0] += y * x
                    s[:, 1] += y * y
    rows_seen = np.zeros(rows, dtype=np.int64)
    if b is None:
        for k in range(-(-rows // S)):
            i = j + k * S
            live = i < rows
            ic = np.minimum(i, rows - 1)
            s[:, 0] += np.where(live, np.asarray(A, dtype=np.float64)[ic, off + ic], 0.0)
            np.add.at(rows_seen, i[live], 1)
    return _grid_sum(s.reshape(blocks, THREADS, 2)), count, rows_seen


@pytest.mark.parametrize("rows,n,blocks", [(1000, 1000, 245), (8192, 8192, 528), (1, 1, 1),
                                           (500, 1000, 123), (4096, 8192, 528)])
def test_k7_plan(rows, n, blocks):
    """At least one 4-group step a thread; a grid that fills the card at
    n = 1000 (245 blocks on 132 SMs), at most four blocks an SM."""
    assert mixed.trace_sums_plan(rows, n, H100_SMS) == blocks
    per_block = mixed.TRACE_SUMS_THREADS * mixed.TRACE_SUMS_UNROLL
    assert blocks * per_block >= -(-rows * n // 4) or blocks == 4 * H100_SMS
    with pytest.raises(ValueError):
        mixed.trace_sums_plan(0, n, H100_SMS)


@pytest.mark.parametrize("n,rows,off", [(300, 300, 0), (257, 257, 0), (301, 150, 151),
                                        (301, 151, 0), (130, 41, 89), (5, 5, 0), (1, 1, 0)])
def test_k7_walk_covers_the_slab_and_matches_plain(n, rows, off):
    """The square H and row slabs, as views of H: off n % 4 != 0 puts the
    slab's base off 16-byte alignment (the scalar-load instance, the same
    order); both calls, each slab's part of each sum."""
    H = _h(n, n + rows)
    H2 = (H @ H).astype(np.float32)
    Hs, H2s = H[off:off + rows], H2[off:off + rows]
    Ht, H2t = torch.as_tensor(H)[off:off + rows], torch.as_tensor(H2)[off:off + rows]
    assert Ht.is_contiguous() and (Ht.data_ptr() % 16 == 0) == ((off * n) % 4 == 0)
    for sms in (H100_SMS, 3):
        (t, seen, rows_seen), (u, seen2, _) = (_k7_walk(Hs, None, off, sms),
                                               _k7_walk(Hs, H2s, 0, sms))
        assert np.all(seen == 1) and np.all(seen2 == 1) and np.all(rows_seen == 1)
        Ha = torch.as_tensor(np.abs(H))[off:off + rows]
        H2a = torch.as_tensor(np.abs(H2))[off:off + rows]
        assert _err(t, mixed.trace_sums_plain(Ht, off).numpy(),
                    mixed.trace_sums_plain(Ha, off).numpy()) <= 1e-12
        assert _err(u, mixed.series_sums_plain(Ht, H2t).numpy(),
                    mixed.series_sums_plain(Ha, H2a).numpy()) <= 1e-12


def test_k7_walk_matches_jax_and_the_slabs_sum():
    """The traces of gpmp_tpu.ops.mixed._mp_solve_and_logdet_core (its nested
    ``_series``), as the JAX package writes them, against the walk on H and
    on XLA's H^2; two ranks' slabs sum to the square H's."""
    n = 256
    H = _h(n, 0)

    @jax.jit
    def jax_traces(H_):
        H2 = (H_ @ H_).astype(jnp.float64)
        H64 = H_.astype(jnp.float64)
        return jnp.stack([jnp.trace(H64), jnp.sum(H64 * H64), jnp.sum(H2 * H64),
                          jnp.sum(H2 * H2)]), H_ @ H_

    ref, H2 = jax_traces(H)
    ref, H2 = np.asarray(ref), np.asarray(H2)
    Ha, H2a = np.abs(H), np.abs(H2)
    scale = np.concatenate([_k7_walk(Ha)[0], _k7_walk(Ha, H2a)[0]])
    walk = np.concatenate([_k7_walk(H)[0], _k7_walk(H, H2)[0]])
    assert _err(walk, ref, scale) <= 1e-12
    h = 101
    parts = (np.concatenate([_k7_walk(H[:h])[0], _k7_walk(H[:h], H2[:h])[0]])
             + np.concatenate([_k7_walk(H[h:], None, h)[0], _k7_walk(H[h:], H2[h:])[0]]))
    assert _err(parts, walk, scale) <= 1e-12


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
class _Lib:
    """Stands in for the built library: the kernels' geometry as csrc/ gives
    it; every other entry is its own name."""

    @staticmethod
    def gpmp_h_traces_geometry(q):
        return (ops.H_TRACES_ROWS, ops.H_TRACES_COLS, ops.H_TRACES_THREADS)[q]

    @staticmethod
    def gpmp_trace_sums_geometry(q):
        return (mixed.TRACE_SUMS_THREADS, mixed.TRACE_SUMS_UNROLL)[q]

    def __getattr__(self, name):
        return name


def test_wrappers_refuse_and_launch(monkeypatch):
    """On CPU tensors the *_cuda entries raise and the dispatchers take the
    plain versions, counting no launch.  With the tensors taken for CUDA
    ones (is_cuda patched, the library and the launch stood in for), wrong
    dtypes, shapes and contiguity raise, and a good call launches its entry
    once with the plan's blocks."""
    n, c = 300, 64
    H = torch.as_tensor(_h(n, 1))
    H2 = H @ H
    H2r = H2[:c].contiguous()
    acc = torch.zeros(4, dtype=torch.float64)
    for call in (lambda: ops.h_traces_chunk_cuda(H, H2r, 0, acc),
                 lambda: mixed.trace_sums_cuda(H),
                 lambda: mixed.series_sums_cuda(H, H2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    before = (ops.K10T_LAUNCHES, mixed.K7_LAUNCHES)
    ops.h_traces_chunk(H, H2r, 0, acc)
    assert torch.equal(mixed.trace_sums(H[c:], c), mixed.trace_sums_plain(H[c:], c))
    assert torch.equal(mixed.series_sums(H, H2), mixed.series_sums_plain(H, H2))
    assert (ops.K10T_LAUNCHES, mixed.K7_LAUNCHES) == before

    launched = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(mixed._build, "load", lambda: _Lib())
    monkeypatch.setattr(mixed._build, "launch",
                        lambda name, fn, dev, *args: launched.append((fn, args)))
    monkeypatch.setattr(mixed, "_sms_on", lambda device: H100_SMS)
    monkeypatch.setattr(ops, "_sms_on", lambda device: H100_SMS)
    mixed._trace_sums_workspace.cache_clear()
    ops._h_traces_workspace.cache_clear()
    bad = [
        lambda: ops.h_traces_chunk_cuda(H.double(), H2r, 0, acc),
        lambda: ops.h_traces_chunk_cuda(H, H2r.double(), 0, acc),
        lambda: ops.h_traces_chunk_cuda(H, H2r, 0, acc.float()),
        lambda: ops.h_traces_chunk_cuda(H, H2r[:, :-1].contiguous(), 0, acc),
        lambda: ops.h_traces_chunk_cuda(H, H2r, n - c + 1, acc),
        lambda: ops.h_traces_chunk_cuda(H, H2r, -1, acc),
        lambda: ops.h_traces_chunk_cuda(H, H2r, 0, acc[:3]),
        lambda: ops.h_traces_chunk_cuda(H[:, :-1].contiguous(), H2r, 0, acc),
        lambda: ops.h_traces_chunk_cuda(H.T, H2r, 0, acc),
        lambda: mixed.trace_sums_cuda(H.double()),
        lambda: mixed.trace_sums_cuda(H[c:], c + 1),
        lambda: mixed.trace_sums_cuda(H[0]),
        lambda: mixed.trace_sums_cuda(H[:, ::2]),
        lambda: mixed.series_sums_cuda(H, H2.double()),
        lambda: mixed.series_sums_cuda(H, H2[:-1]),
        lambda: mixed.series_sums_cuda(H.double(), H2.double()),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert not launched and (ops.K10T_LAUNCHES, mixed.K7_LAUNCHES) == before

    r0 = 128
    Hs = H[r0:r0 + c]
    ops.h_traces_chunk_cuda(H, H2r, r0, acc)
    out_t = mixed.trace_sums_cuda(Hs, r0)
    out_s = mixed.series_sums_cuda(Hs, H2[r0:r0 + c])
    assert [fn for fn, _ in launched] == ["gpmp_h_traces", "gpmp_trace_sums", "gpmp_trace_sums"]
    (_, k10t), (_, tr), (_, se) = launched
    assert k10t[:2] == (H.data_ptr(), H2r.data_ptr()) and k10t[4] == acc.data_ptr()
    assert k10t[5:] == (r0, c, n, ops.h_traces_plan(c, n, H100_SMS)[2])
    blocks = mixed.trace_sums_plan(c, n, H100_SMS)
    assert tr[:2] == (Hs.data_ptr(), None) and tr[4] == out_t.data_ptr()
    assert tr[5:] == (c, n, r0, blocks)
    assert se[1] == H2[r0:r0 + c].data_ptr() and se[5:] == (c, n, 0, blocks)
    # one workspace for both K7 calls at (rows, n); its pointers are passed
    assert tr[2:4] == se[2:4] == mixed._trace_sums_workspace(torch.device("cpu"), c, n)[1:3]
    assert out_t.shape == out_s.shape == (2,) and out_t.dtype == torch.float64
    assert (ops.K10T_LAUNCHES, mixed.K7_LAUNCHES) == (before[0] + 1, before[1] + 2)
    mixed._trace_sums_workspace.cache_clear()
    ops._h_traces_workspace.cache_clear()
