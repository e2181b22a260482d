# tests/test_torch_distance_walk.py
"""K1d's geometry and order of sums on the CPU (gpmp_tpu_torch.ops.distance).

The kernels run only on a CUDA card (chip_smoke.py phase 2c holds them to
their plain versions there).  Here the grids their wrappers pass them,
``distance_plan`` (the full forward and pullback) and ``elementwise_plan``
(the elementwise pullback), and the order in which the pullbacks sum:

- coverage: the persistent grid, block b taking the items b, b + blocks, ...
  (an item a strip of 32 lanes' column groups times a chunk of rows, warp w
  the rows r0 + w, r0 + w + 8, ...), visits every (i, j) exactly once, for
  n, m in {1, 31, 33, 1000, 4099} (odd m: the scalar-access instance), f64
  and f32 column groups, 1 and 132 SMs;
- walk vs plain and JAX: a walk of the pullback in the kernel's fixed order
  (a thread's items, rows and columns in order, csrc/fixed_sum.cuh's
  butterfly over the lanes and the warps in order, then the last block's
  sum over the block partials) is within 1e-12 of
  ``scaled_distance_pullback_plain`` (d in {1, 8, 9, 32}) and within 1e-11
  of ``jax.grad`` of gpmp_tpu's ``scaled_distance`` (d = 6), at n <= 256,
  x is y and x != y, with coincident points; and so is the elementwise
  walk;
- the ``*_cuda`` wrappers refuse CPU tensors, mixed dtypes, non-contiguous
  tensors and d > MAX_D before anything is built, and hand their kernel the
  plan and the cached workspace.

About 2 s of test time on the CPU, 5-6 s with its imports (torch on 2
threads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp
from _fixed_sum_walk import THREADS, grid_sum
from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import distance

H100_SMS = 132  # the card's SM count, as the wrappers read it there
SIZES = (1, 31, 33, 1000, 4099)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _items(n, m, itemsize, sms):
    """distance_plan's walk: per block, its items in order, each as (rows of
    each warp, columns of each lane)."""
    strips, chunk_rows, blocks = distance.distance_plan(n, m, itemsize, sms)
    cols = 16 // itemsize
    items = strips * -(-n // chunk_rows)
    for b in range(blocks):
        for t in range(b, items, blocks):
            r0 = t // strips * chunk_rows
            r1 = min(n, r0 + chunk_rows)
            j0 = t % strips * 32 * cols
            yield (b, t, [range(r0 + w, r1, distance.WARPS) for w in range(distance.WARPS)],
                   [range(min(m, j0 + cols * lane), min(m, j0 + cols * (lane + 1)))
                    for lane in range(32)])


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("itemsize", [8, 4])
def test_plan_visits_every_entry_once(itemsize, sms):
    for n in SIZES:
        for m in SIZES:
            strips, chunk_rows, blocks = distance.distance_plan(n, m, itemsize, sms)
            assert chunk_rows % distance.WARPS == 0
            assert 1 <= blocks <= distance.BLOCKS_PER_SM * sms
            count = np.zeros((n, m), dtype=np.int8)
            taken = []
            for _b, t, rows, cols in _items(n, m, itemsize, sms):
                taken.append(t)
                r = np.concatenate([np.asarray(w, dtype=np.int64) for w in rows])
                c = np.concatenate([np.asarray(ln, dtype=np.int64) for ln in cols])
                # the warps' rows and the lanes' columns are contiguous ranges
                # taken once each, so the item is one rectangle
                r.sort(), c.sort()
                assert np.array_equal(r, np.arange(r[0], r[0] + len(r)))
                assert np.array_equal(c, np.arange(c[0], c[0] + len(c)))
                count[r[0]:r[-1] + 1, c[0]:c[-1] + 1] += 1
            assert sorted(taken) == list(range(len(taken)))
            assert (count == 1).all(), (n, m, itemsize, sms)


def _d2(diff):
    """sum of squares over the last axis, in the kernel's order over k."""
    d2 = np.zeros(diff.shape[:-1])
    for k in range(diff.shape[-1]):
        d2 = d2 + diff[..., k] * diff[..., k]
    return d2


def _pullback_walk(dbar, l, x, y, sms):
    """The f64 pullback in the kernel's order: each thread's terms
    w (diff_k)^2, w = Dbar rsqrt(D^2) (0 where D = 0), over its items, rows
    and columns in order, then grid_sum."""
    n, m = dbar.shape
    el = np.exp(l)
    diff = (el * x)[:, None, :] - (el * y)[None, :, :]
    d2 = _d2(diff)
    pos = d2 > 0
    terms = np.where(pos, dbar * (1.0 / np.sqrt(np.where(pos, d2, 1.0))), 0.0)[..., None] * (
        diff * diff)
    blocks = distance.distance_plan(n, m, 8, sms)[2]
    acc = np.zeros((blocks, THREADS, x.shape[1]))
    for b, _t, rows, cols in _items(n, m, 8, sms):
        # the lanes' columns, one at a time in each lane's order
        lanes = [np.array([lane for lane, lc in enumerate(cols) if len(lc) > c], dtype=int)
                 for c in (0, 1)]
        js = [np.array([lc[c] for lc in cols if len(lc) > c], dtype=int) for c in (0, 1)]
        for w, wrows in enumerate(rows):
            for i in wrows:
                for ln, j in zip(lanes, js):
                    acc[b, 32 * w + ln] += terms[i, j]
    return grid_sum(acc)


def _elementwise_walk(dbar, l, x, y, sms):
    n = x.shape[0]
    diff = np.exp(l) * (x - y)
    h = np.sqrt(_d2(diff))
    pos = h > 0
    terms = np.where(pos, dbar / np.where(pos, h, 1.0), 0.0)[:, None] * (diff * diff)
    blocks = distance.elementwise_plan(n, sms)
    acc = np.zeros((blocks * distance.EW_THREADS, x.shape[1]))
    stride = len(acc)
    for j0 in range(0, n, stride):
        rows = np.arange(j0, min(n, j0 + stride))
        acc[rows - j0] += terms[rows]
    return grid_sum(acc.reshape(blocks, distance.EW_THREADS, -1))


def _inputs(n, m, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[3:5] = x[0:2]  # duplicated rows
    y = rng.uniform(size=(m, d))
    y[:2] = x[:2]  # coincident x/y points
    return x, y, rng.uniform(-0.5, 1.5, size=d), rng.normal(size=(n, m))


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b)))


def _walk_case(d, kind):
    """(walks on 1 and 132 SMs' grids, plain, the inputs and dbar) for the
    pullback of ``kind`` at d: n = 96 (70 x 131 for cross), coincident
    points."""
    n, m = (96, 96) if kind != "cross" else (70, 131)
    x, y, l0, dbar = _inputs(n, m, d, seed=d + len(kind))
    if kind == "same":
        y = x
    lt, xt, yt = (torch.as_tensor(a) for a in (l0, x, y))
    if kind == "elementwise":
        dbar = dbar[:, 0]
        plain = distance.scaled_distance_elementwise_pullback_plain(torch.as_tensor(dbar), lt,
                                                                    xt, yt).numpy()
        walks = [_elementwise_walk(dbar, l0, x, y, sms) for sms in (1, H100_SMS)]
    else:
        plain = distance.scaled_distance_pullback_plain(torch.as_tensor(dbar), lt, xt, yt).numpy()
        walks = [_pullback_walk(dbar, l0, x, y, sms) for sms in (1, H100_SMS)]
    return walks, plain, (l0, x, y, dbar)


@pytest.mark.parametrize("kind", ["cross", "same", "elementwise"])
@pytest.mark.parametrize("d", [1, 8, 9, 32])
def test_walk_matches_plain(d, kind):
    """The kernels' order against the plain pullback, 1e-12: f64 sums of the
    same terms in another order (d = 9, 32: the instance for d up to
    MAX_D)."""
    walks, plain, _ = _walk_case(d, kind)
    for walk in walks:
        assert _rel(walk, plain) <= 1e-12


@pytest.mark.parametrize("kind", ["cross", "same", "elementwise"])
def test_walk_matches_jax(kind):
    """The kernels' order against jax.grad of gpmp_tpu's scaled_distance
    (and its elementwise twin), 1e-11 as tests/test_torch_distance.py, at
    bench.py's d = 6."""
    walks, plain, (l0, x, y, dbar) = _walk_case(6, kind)
    jfn = jgnp.scaled_distance_elementwise if kind == "elementwise" else jgnp.scaled_distance
    ref = np.asarray(jax.jit(jax.grad(lambda l: jnp.sum(
        jnp.asarray(dbar) * jfn(l, jnp.asarray(x), jnp.asarray(y)))))(jnp.asarray(l0)))
    assert _rel(plain, ref) <= 1e-11
    for walk in walks:
        assert _rel(walk, ref) <= 1e-11


class _Lib:
    """Stands in for the built library: K1d's geometry as csrc/distance.cu
    gives it; every other entry is its own name."""

    geometry = (distance.THREADS, distance.ROW_UNROLL, distance.EXACT_MAX_D, distance.MAX_D,
                distance.EW_THREADS)

    def gpmp_distance_geometry(self, q):
        return self.geometry[q]

    def __getattr__(self, name):
        return name


def _clear_caches():
    for fn in (distance._library, distance._plan_on, distance._pullback_workspace):
        fn.cache_clear()


def test_wrappers_refuse_and_launch(monkeypatch):
    """On CPU tensors the *_cuda entries raise.  With the tensors taken for
    CUDA ones (is_cuda patched, the library and the launch stood in for),
    mixed dtypes, non-contiguous tensors, d > MAX_D and wrong shapes raise
    before anything is built; a good call launches its entry once with the
    plan and the cached workspace; a library of another geometry is
    refused."""
    x, y, l0, dbar = _inputs(40, 33, 3, seed=5)
    X, Y, L, DB = (torch.as_tensor(a) for a in (x, y, l0, dbar))
    calls = (lambda: distance.scaled_distance_cuda(L, X, Y),
             lambda: distance.scaled_distance_pullback_cuda(DB, L, X, Y),
             lambda: distance.scaled_distance_elementwise_cuda(L, X, X),
             lambda: distance.scaled_distance_elementwise_pullback_cuda(DB[:, 0].contiguous(),
                                                                        L, X, X))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()

    launched, loads = [], []
    # the stood-in launches count; the module's counters are restored after
    monkeypatch.setattr(distance, "K1D_LAUNCHES", 0)
    monkeypatch.setattr(distance, "K1D_PULLBACK_LAUNCHES", 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(distance._build, "load", lambda: loads.append(1) or _Lib())
    monkeypatch.setattr(distance._build, "launch",
                        lambda name, fn, dev, *args: launched.append((fn, args)))
    monkeypatch.setattr(distance, "_sms_on", lambda device: H100_SMS)
    _clear_caches()
    wide = torch.zeros(distance.MAX_D + 1, dtype=torch.float64)
    bad = [
        lambda: distance.scaled_distance_cuda(L.float(), X, Y),
        lambda: distance.scaled_distance_cuda(L, X, Y.float()),
        lambda: distance.scaled_distance_pullback_cuda(DB.float(), L, X, Y),
        lambda: distance.scaled_distance_cuda(L, X.T.contiguous().T, Y),
        lambda: distance.scaled_distance_pullback_cuda(DB.T.contiguous().T, L, X, Y),
        lambda: distance.scaled_distance_cuda(wide, torch.zeros(4, distance.MAX_D + 1,
                                                                dtype=torch.float64),
                                              torch.zeros(3, distance.MAX_D + 1,
                                                          dtype=torch.float64)),
        lambda: distance.scaled_distance_cuda(L[:2], X, Y),
        lambda: distance.scaled_distance_pullback_cuda(DB[:, :5], L, X, Y),
        lambda: distance.scaled_distance_elementwise_cuda(L, X, Y),
        lambda: distance.scaled_distance_elementwise_pullback_cuda(DB, L, X, X),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert not launched and not loads

    D = distance.scaled_distance_cuda(L, X, Y)
    g = distance.scaled_distance_pullback_cuda(DB, L, X, Y)
    distance.scaled_distance_pullback_cuda(DB, L, X, Y)
    ge = distance.scaled_distance_elementwise_pullback_cuda(DB[:, 0].contiguous(), L, X, X)
    assert [fn for fn, _ in launched] == ["gpmp_distance_f64", "gpmp_distance_pullback_f64",
                                          "gpmp_distance_pullback_f64",
                                          "gpmp_distance_elementwise_pullback_f64"]
    plan = distance.distance_plan(40, 33, 8, H100_SMS)
    (_, fwd), (_, pb), (_, pb2), (_, ew) = launched
    assert fwd == (X.data_ptr(), Y.data_ptr(), L.data_ptr(), D.data_ptr(), 40, 33, 3, *plan)
    assert pb[:4] == (DB.data_ptr(), X.data_ptr(), Y.data_ptr(), L.data_ptr())
    assert pb[6:] == (g.data_ptr(), 40, 33, 3, *plan)
    # one workspace a shape: the same partials and ticket on every call
    assert pb[4:6] == pb2[4:6] == distance._pullback_workspace(X.device, 40, 33, 3,
                                                               torch.float64, False)[1:3]
    assert ew[-3:] == (40, 3, distance.elementwise_plan(40, H100_SMS))
    assert ew[4:6] != pb[4:6]
    assert D.shape == (40, 33) and g.shape == ge.shape == (3,) and g.dtype == torch.float64
    assert (distance.K1D_LAUNCHES, distance.K1D_PULLBACK_LAUNCHES) == (1, 3)
    assert len(loads) == 1  # the geometry is read once

    _clear_caches()
    monkeypatch.setattr(_Lib, "geometry", (128, *_Lib.geometry[1:]))
    with pytest.raises(RuntimeError, match="geometry"):
        distance.scaled_distance_cuda(L, X, Y)
    _clear_caches()
