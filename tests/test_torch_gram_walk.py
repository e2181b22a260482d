# tests/test_torch_gram_walk.py
"""K1's and K2's geometry and K2's order of sums on the CPU
(gpmp_tpu_torch.ops.gram).

The kernels run only on a CUDA card (chip_smoke.py phase 2 holds them to
their plain versions there).  Here the grid their wrappers pass them,
``gram_plan``, and the order in which K2 sums:

- coverage: the persistent grid, block b taking the items b, b + blocks, ...
  (TILE x TILE tiles: for x is y the pairs I <= J, else every (I, J); a
  thread 16 / itemsize columns of a few rows of a tile), computes each
  unordered pair {i, j} once for x is y and writes both (i, j) and (j, i)
  once (K1's mirrored stores), and each (i, j) once for x != y, for n, m in
  {1, 31, 33, 64, 65, 997, 1000, 4099}, f64 and f32, 1 and 132 SMs;
- walk vs plain and JAX: a walk of K2 in the kernel's fixed order (a
  thread's items, rows and columns in order, masked entries skipped, each
  pair of x is y weighted by Kbar_ij + Kbar_ji, then csrc/fixed_sum.cuh's
  butterfly over the lanes, the warps in order and the last block's sum
  over the block partials) is within 1e-12 of ``matern_gram_pullback_plain``
  and within 1e-11 of ``jax.grad`` of gpmp_tpu's ``maternp_covariance``, x is
  y and x != y, p in {0, 2, 3, 5}, d in {1, 6, 9}, with coincident points
  and a non-symmetric Kbar;
- the kernels' Horner of degree FIXED_P on the zero-padded coefficients is
  bitwise the degree-p one for p <= FIXED_P, in f64 and f32;
- the ``*_cuda`` wrappers refuse CPU tensors, mixed dtypes, non-contiguous
  tensors, d > MAX_D and x is y with another y before anything is built,
  and hand their kernel the plan and the cached workspace.

About 4 s of test time on the CPU, most of it one jitted JAX program (torch
on 2 threads).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu.kernel as jkernel
import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
from _fixed_sum_walk import grid_sum
from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import gram

H100_SMS = 132  # the card's SM count, as the wrappers read it there
SIZES = (1, 31, 33, 64, 65, 997, 1000, 4099)
T, THREADS = gram.TILE, gram.THREADS


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _thread_entries(itemsize):
    """(rows, cols), each (THREADS, S C): thread tid's entries of a tile in
    its order (row s, then column q), as the kernels lay them out."""
    c = 16 // itemsize
    lpr = T // c
    rw = 32 // lpr
    rb = THREADS // 32 * rw
    tid = np.arange(THREADS)
    lane, warp = tid % 32, tid // 32
    c0 = c * (lane % lpr)
    r0 = warp * rw + lane // lpr
    rows = [r0 + s * rb for s in range(T // rb) for _q in range(c)]
    cols = [c0 + q for _s in range(T // rb) for q in range(c)]
    return np.stack(rows, axis=1), np.stack(cols, axis=1)


def _tile_of(t, tj, same):
    """Item t's tile (I, J) by gram_plan's order: x is y, t = J (J + 1) / 2
    + I with I <= J; else t = I tj + J."""
    if same:
        J = int((np.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
        J -= J * (J + 1) // 2 > t
        J += (J + 1) * (J + 2) // 2 <= t
        return t - J * (J + 1) // 2, J
    return divmod(t, tj)


def _items(n, m, same, sms):
    """gram_plan's walk: (block, I, J) of every item, in each block's order."""
    _tile, items, blocks = gram.gram_plan(n, m, same, 8, sms)
    tj = -(-m // T)
    for b in range(blocks):
        for t in range(b, items, blocks):
            yield (b, *_tile_of(t, tj, same))


def _computed(itemsize, tiles, n, m, same):
    """(i, j) of the entries that the items ``tiles`` ((I, J) rows)
    compute, every (tile, thread, entry) masked as the kernels mask it."""
    rows, cols = _thread_entries(itemsize)
    i = tiles[:, :1, None] * T + rows[None]
    j = tiles[:, 1:, None] * T + cols[None]
    keep = (i < n) & (j < m)
    if same:
        keep &= (tiles[:, :1, None] < tiles[:, 1:, None]) | (rows <= cols)[None]
    return i[keep], j[keep]


def _check_counts(count, same):
    """x != y: each (i, j) computed once; x is y: each i <= j computed once,
    and with K1's mirrored stores every entry written once."""
    if same:
        assert (count == np.triu(np.ones_like(count))).all()
        count = count + count.T - np.diag(np.diag(count))
    assert (count == 1).all()


@pytest.mark.parametrize("itemsize", [8, 4])
def test_plan_computes_every_pair_once(itemsize):
    """Each thread's entries cover a tile once; every block's items cover
    the tile pairs once (1 and 132 SMs); within each kind of tile (ragged
    rows or columns, diagonal) the masked entries are its in-range ones (x
    is y on the diagonal: r <= c), so every pair is computed once; and
    counted entry by entry where n, m <= 65 and at n = m = 1000."""
    rows, cols = _thread_entries(itemsize)
    assert sorted((rows * T + cols).ravel()) == list(range(T * T))
    for same in (True, False):
        for n in SIZES:
            for m in (n,) if same else SIZES:
                tile, items, blocks = gram.gram_plan(n, m, same, itemsize, H100_SMS)
                assert tile == T and 1 <= blocks <= gram.BLOCKS_PER_SM * H100_SMS
                ti, tj = -(-n // T), -(-m // T)
                for sms in (1, H100_SMS):
                    tiles = np.array([w[1:] for w in _items(n, m, same, sms)])
                    assert len(tiles) == items
                    seen = np.zeros((ti, tj), dtype=int)
                    np.add.at(seen, (tiles[:, 0], tiles[:, 1]), 1)
                    assert (seen == (np.triu(np.ones_like(seen)) if same else 1)).all()
                # one tile of each kind, at the origin: its local count
                kinds = {(min(T, n - I * T), min(T, m - J * T), same and I == J)
                         for I, J in tiles}
                for rows_in, cols_in, diag in kinds:
                    i, j = _computed(itemsize, np.array([[0, 0]]), rows_in, cols_in, diag)
                    _check_counts(np.bincount(i * cols_in + j, minlength=rows_in * cols_in)
                                  .reshape(rows_in, cols_in), diag)
                if max(n, m) <= 65 or n == m == 1000:
                    i, j = _computed(itemsize, tiles, n, m, same)
                    _check_counts(np.bincount(i * m + j, minlength=n * m).reshape(n, m), same)


def _inputs(n, m, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[3:5] = x[0:2]  # duplicated rows
    y = rng.uniform(size=(m, d))
    y[:2] = x[:2]  # coincident x/y points
    theta = np.concatenate([[0.4], rng.uniform(-0.5, 1.5, size=d)])
    return x, y, theta, rng.normal(size=(n, m))  # Kbar: not symmetric


def _padded_coeffs(p):
    """a and b zero-padded to degree FIXED_P (p <= FIXED_P), as
    csrc/matern_gram.cu's coef_of passes them to the kernels by value."""
    pad = [0.0] * (gram.FIXED_P - p)
    return gram._maternp_poly_coeffs(p) + pad, gram._maternp_dpoly_coeffs(p) + pad


def _padded_horner(coeffs, t):
    acc = np.full_like(t, coeffs[-1])
    for ck in reversed(coeffs[:-1]):
        acc = acc * t + ck
    return acc


def _pullback_walk(kbar, x, y, p, theta, same, sms):
    """K2 (f64) in the kernel's order: each thread's terms over its items,
    rows and columns in order (x is y: the entries i <= j, weighted by
    Kbar_ij + Kbar_ji off the diagonal), then grid_sum.  h and 1/h from
    1/sqrt(d2) as the kernel's one rsqrt."""
    n, m = kbar.shape
    c = 2.0 * math.sqrt(p + 0.5)
    a, b = _padded_coeffs(p) if p <= gram.FIXED_P else (
        gram._maternp_poly_coeffs(p), gram._maternp_dpoly_coeffs(p))
    sigma2, el = np.exp(theta[0]), np.exp(theta[1:])
    diff = (el * x)[:, None, :] - (el * y)[None, :, :]
    sq = diff * diff
    d2 = np.zeros((n, m))
    for k in range(x.shape[1]):
        d2 = d2 + sq[..., k]
    pos = d2 > 0
    r = np.where(pos, 1.0 / np.sqrt(np.where(pos, d2, 1.0)), 0.0)
    h = d2 * r
    e = np.exp(-c * h)
    kij = sigma2 * (e * _padded_horner(a, 2 * c * h))
    wkb = kbar.copy()
    if same:
        kij = kij + np.eye(n) * 10.0 * sigma2 * np.finfo(np.float64).eps
        wkb = kbar + kbar.T - np.diag(np.diag(kbar))
    w = np.where(pos, wkb * sigma2 * (c * e * _padded_horner(b, 2 * c * h)) * r, 0.0)
    terms = np.concatenate([(wkb * kij)[..., None], w[..., None] * sq], axis=-1)
    rows, cols = _thread_entries(8)
    blocks = gram.gram_plan(n, m, same, 8, sms)[2]
    acc = np.zeros((blocks, THREADS, terms.shape[-1]))
    for blk, I, J in _items(n, m, same, sms):
        for e_ in range(rows.shape[1]):
            i, j = I * T + rows[:, e_], J * T + cols[:, e_]
            keep = (i < n) & (j < m) & ((I < J) | (rows[:, e_] <= cols[:, e_]) | (not same))
            acc[blk, keep] += terms[i[keep], j[keep]]
    return grid_sum(acc)


P_SET, D_SET, SHAPES = (0, 2, 3, 5), (1, 6, 9), {True: (70, 70), False: (70, 45)}
CASES = [(d, p, same) for d in D_SET for p in P_SET for same in (True, False)]


def _case_inputs(d, same):
    x, y, theta, kbar = _inputs(*SHAPES[False], d, seed=d)
    if same:
        return x, x, theta, _inputs(*SHAPES[True], d, seed=d + 100)[3]
    return x, y, theta, kbar


def _jax_grads(args):
    """jax.grad of <Kbar, gpmp_tpu's maternp_covariance> at every case, in
    one compiled program."""
    return [jax.grad(lambda th, x=x, y=y, kb=kb, p=p, same=same: jnp.sum(
        kb * jkernel.maternp_covariance(x, x if same else y, p, th)))(theta)
        for (_d, p, same), (x, y, theta, kb) in zip(CASES, args)]


@pytest.fixture(scope="module")
def walks():
    """Every case's (walks on 1 and 132 SMs' grids, plain, JAX)."""
    inputs = [_case_inputs(d, same) for d, _p, same in CASES]
    refs = jax.jit(_jax_grads)([tuple(jnp.asarray(a) for a in args) for args in inputs])
    out = {}
    for (d, p, same), (x, y, theta, kb), ref in zip(CASES, inputs, refs):
        plain = gram.matern_gram_pullback_plain(
            torch.as_tensor(kb), torch.as_tensor(x), torch.as_tensor(y), p,
            torch.as_tensor(theta), same).numpy()
        out[(d, p, same)] = ([_pullback_walk(kb, x, y, p, theta, same, sms)
                              for sms in (1, H100_SMS)], plain, np.asarray(ref))
    return out


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b)))


@pytest.mark.parametrize("same", [True, False], ids=["same", "cross"])
@pytest.mark.parametrize("p", P_SET)
@pytest.mark.parametrize("d", D_SET)
def test_walk_matches_plain_and_jax(walks, d, p, same):
    """The kernel's order against the plain pullback (1e-12: f64 sums of the
    same terms in another order) and against jax.grad of gpmp_tpu's
    maternp_covariance (1e-11, as tests/test_torch_gram.py)."""
    ws, plain, ref = walks[(d, p, same)]
    assert _rel(plain, ref) <= 1e-11
    for walk in ws:
        assert _rel(walk, plain) <= 1e-12
        assert _rel(walk, ref) <= 1e-11


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_padded_horner_is_bitwise_degree_p(dtype):
    """0 t + a = a for finite t: Horner of degree FIXED_P on the zero-padded
    coefficients gives the degree-p result bit for bit, p <= FIXED_P, both
    polynomials, on random t >= 0 (and t = 0) in the working type."""
    t = np.concatenate([[0.0], np.random.default_rng(3).uniform(0, 60, size=4000)]).astype(dtype)
    for p in range(gram.FIXED_P + 1):
        a, b = _padded_coeffs(p)
        assert len(a) == len(b) == gram.FIXED_P + 1
        for full, exact in ((a, gram._maternp_poly_coeffs(p)), (b, gram._maternp_dpoly_coeffs(p))):
            got = _padded_horner([dtype(v) for v in full], t)
            want = _padded_horner([dtype(v) for v in exact], t)
            assert got.dtype == dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8))


class _Lib:
    """Stands in for the built library: K1/K2's geometry as
    csrc/matern_gram.cu gives it; every other entry is its own name."""

    geometry = (gram.THREADS, gram.TILE, gram.EXACT_MAX_D, gram.MAX_D, gram.FIXED_P,
                gram.BLOCKS_PER_SM)

    def gpmp_matern_geometry(self, q):
        return self.geometry[q]

    def __getattr__(self, name):
        return name


def _clear_caches():
    for fn in (gram._library, gram._plan_on, gram._pullback_workspace):
        fn.cache_clear()


def test_wrappers_refuse_and_launch(monkeypatch):
    """On CPU tensors the *_cuda entries raise.  With the tensors taken for
    CUDA ones (is_cuda patched, the library and the launch stood in for),
    mixed dtypes, non-contiguous tensors, d > MAX_D, wrong shapes and
    same=True with y not x raise before anything is built; a good call
    launches its entry once with the coefficients, the plan and the cached
    workspace; a library of another geometry is refused."""
    x, y, theta, kbar = _inputs(40, 33, 3, seed=5)
    X, Y, TH, KB = (torch.as_tensor(v) for v in (x, y, theta, kbar))
    KS = torch.as_tensor(np.random.default_rng(6).normal(size=(40, 40)))
    for call in (lambda: gram.matern_gram_cuda(X, Y, 2, TH),
                 lambda: gram.matern_gram_pullback_cuda(KB, X, Y, 2, TH)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()

    launched, loads = [], []
    monkeypatch.setattr(gram, "K1_LAUNCHES", 0)
    monkeypatch.setattr(gram, "K2_LAUNCHES", 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(gram._build, "load", lambda: loads.append(1) or _Lib())
    monkeypatch.setattr(gram._build, "launch",
                        lambda name, fn, dev, *args: launched.append((fn, args)))
    monkeypatch.setattr(gram, "_sms_on", lambda device: H100_SMS)
    _clear_caches()
    wide = torch.zeros(gram.MAX_D + 2, dtype=torch.float64)
    wx = torch.zeros(4, gram.MAX_D + 1, dtype=torch.float64)
    bad = [
        lambda: gram.matern_gram_cuda(X, Y, 2, TH.float()),
        lambda: gram.matern_gram_cuda(X, Y.float(), 2, TH),
        lambda: gram.matern_gram_pullback_cuda(KB.float(), X, Y, 2, TH),
        lambda: gram.matern_gram_cuda(X.T.contiguous().T, Y, 2, TH),
        lambda: gram.matern_gram_pullback_cuda(KB.T.contiguous().T, X, Y, 2, TH),
        lambda: gram.matern_gram_cuda(wx, wx, 2, wide, True),
        lambda: gram.matern_gram_cuda(X, Y, 2, TH[:2]),
        lambda: gram.matern_gram_cuda(X, Y, -1, TH),
        lambda: gram.matern_gram_pullback_cuda(KB[:, :5].contiguous(), X, Y, 2, TH),
        lambda: gram.matern_gram_cuda(X, X.clone(), 2, TH, True),
        lambda: gram.matern_gram_pullback_cuda(KS, X, X.clone(), 2, TH, True),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert not launched and not loads

    K = gram.matern_gram_cuda(X, X, 2, TH, True)
    g = gram.matern_gram_pullback_cuda(KS, X, X, 5, TH, True)
    gram.matern_gram_pullback_cuda(KS, X, X, 5, TH, True)
    gc = gram.matern_gram_pullback_cuda(KB, X, Y, 2, TH)
    assert [fn for fn, _ in launched] == ["gpmp_matern_gram_f64"] + [
        "gpmp_matern_pullback_f64"] * 3
    (_, fwd), (_, pb), (_, pb2), (_, pbc) = launched
    eps = float(np.finfo(np.float64).eps)
    assert fwd[:3] == (X.data_ptr(), X.data_ptr(), TH.data_ptr())
    assert list(fwd[3]) == gram._coef_values(2) and fwd[4] is None  # p <= FIXED_P: by value
    assert fwd[5:] == (K.data_ptr(), 40, 40, 3, 2, 1, eps, *gram.gram_plan(40, 40, True, 8,
                                                                        H100_SMS))
    assert list(pb[4]) == gram._coef_values(5)
    assert pb[5] == gram._coef_tensor(5, X.device).data_ptr()  # p > FIXED_P: the device array
    ws = gram._pullback_workspace(X.device, 40, 40, 3, torch.float64, True)
    assert pb[6:8] == pb2[6:8] == ws[1:3]  # one workspace a shape
    assert pb[8:] == (g.data_ptr(), 40, 40, 3, 5, 1, eps, *ws[0])
    assert pbc[6:8] != pb[6:8] and pbc[-3:] == gram.gram_plan(40, 33, False, 8, H100_SMS)
    assert K.shape == (40, 40) and g.shape == gc.shape == (4,) and g.dtype == torch.float64
    assert (gram.K1_LAUNCHES, gram.K2_LAUNCHES) == (1, 3)
    assert len(loads) == 1  # the geometry is read once

    _clear_caches()
    monkeypatch.setattr(_Lib, "geometry", (2 * gram.THREADS, *_Lib.geometry[1:]))
    with pytest.raises(RuntimeError, match="geometry"):
        gram.matern_gram_cuda(X, Y, 2, TH)
    _clear_caches()
