# tests/test_torch_dataloader.py
"""The port's Dataset, DataLoader, scalers and collate_batches against
gpmp_tpu's on the same NumPy inputs, on the CPU in f64 (the cases of
tests/test_dataloader.py, held to the JAX package):

- the same batches, bitwise, for the same seed and epoch (the host NumPy
  generators are kept), and the same splits, folds and stacked batches;
- the streaming reductions at 1e-14 relative (max|diff| / max|ref|);
- the scalers with NumPy's population std (ddof 0);
- no Dataset or scaler writes into, or shares memory with, the caller's
  NumPy array;
- a JAX Dataset carried across with ``interop.dataset_from_numpy``.
"""

import numpy as np
import pytest
import torch

import gpmp_tpu.num as jgnp
from gpmp_tpu import dataloader as jdl
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch import dataloader as tdl

TOL = 1e-14


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _data(n=20, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(size=(n,))


def _np(a):
    return np.asarray(tgnp.to_np(a))


def _relmax(a, b):
    a, b = np.asarray(_np(a), dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _both(x, z, cuts=()):
    """The same sharded dataset in both packages (shards split at cuts)."""
    edges = [0, *cuts, x.shape[0]]
    xs = [x[a:b] for a, b in zip(edges[:-1], edges[1:])]
    zs = [z[a:b] for a, b in zip(edges[:-1], edges[1:])]
    jds = jdl.Dataset([jgnp.asarray(s) for s in xs], [jgnp.asarray(s) for s in zs])
    tds = tgp.interop.dataset_from_numpy(xs, zs, device="cpu", dtype=torch.float64)
    return jds, tds


def _same_batches(jbatches, tbatches):
    assert len(jbatches) == len(tbatches)
    for (jx, jz), (tx, tz) in zip(jbatches, tbatches):
        assert isinstance(tx, torch.Tensor) and isinstance(tz, torch.Tensor)
        np.testing.assert_array_equal(_np(tx), np.asarray(jx))
        np.testing.assert_array_equal(_np(tz), np.asarray(jz))


def test_sharded_equals_unsharded_and_jax():
    x, z = _data(20)
    ds1 = tdl.Dataset(x, z)
    jds, ds2 = _both(x, z, (7, 15))
    assert len(ds1) == len(ds2) == len(jds) == 20
    assert repr(ds2) == repr(jds)
    for i in [0, 6, 7, 14, 15, 19]:
        for a, b in zip(ds1[i], ds2[i]):
            np.testing.assert_array_equal(_np(a), _np(b))
        for a, b in zip(ds2[i], jds[i]):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_subset_split_and_folds_as_jax():
    x, z = _data(40)
    jds, tds = _both(x, z, (17,))
    idx = np.array([2, 5, 30, 13, 39])
    for sub_j, sub_t in ((jds.subset(idx), tds.subset(idx)),
                         (jds.subset(idx), tds.subset(torch.as_tensor(idx)))):
        assert len(sub_t) == 5
        _same_batches(list(zip(sub_j.x_list, sub_j.z_list)), list(zip(sub_t.x_list, sub_t.z_list)))
    with pytest.raises(ValueError, match="1D"):
        tds.subset(np.zeros((2, 2), dtype=int))
    for ratios, seed in (((0.5, 0.25, 0.25), 11),):
        parts_j = jdl.Dataset.split(jds, ratios, seed=seed)
        parts_t = tdl.Dataset.split(tds, ratios, seed=seed)
        assert [len(p) for p in parts_t] == [len(p) for p in parts_j]
        for pj, pt in zip(parts_j, parts_t):
            _same_batches(list(zip(pj.x_list, pj.z_list)), list(zip(pt.x_list, pt.z_list)))
    for args in ((23, 4, 1), (10, 3, 0)):
        for (tj, vj), (tt, vt) in zip(jdl.Dataset.k_fold_indices(*args[:2], seed=args[2]),
                                      tdl.Dataset.k_fold_indices(*args[:2], seed=args[2])):
            np.testing.assert_array_equal(tt, tj)
            np.testing.assert_array_equal(vt, vj)
    folds = tdl.Dataset.k_fold_indices(23, 4, seed=1)
    np.testing.assert_array_equal(np.sort(np.concatenate([v for _t, v in folds])), np.arange(23))
    rj = jdl.Dataset.repeated_k_fold_indices(10, 2, 3, seed=5)
    rt = tdl.Dataset.repeated_k_fold_indices(10, 2, 3, seed=5)
    assert len(rt) == 6
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("field", ("x", "z"))
def test_reductions_as_jax(field):
    x, z = _data(30)
    jds, tds = _both(x, z, (11,))
    for stat in ("min", "max", "mean", "var", "std", "median"):
        t = getattr(tds, f"{field}_{stat}")()
        assert isinstance(t, torch.Tensor)
        assert _relmax(t, np.asarray(getattr(jds, f"{field}_{stat}")())) <= TOL
    for q in (0.0, 0.1, 0.5, 0.93, 1.0):
        assert _relmax(getattr(tds, f"{field}_quantile")(q),
                       np.asarray(getattr(jds, f"{field}_quantile")(q))) <= TOL
        assert _relmax(tds._reduce_quantile_approx(field, q, sample_size=16),
                       np.asarray(jds._reduce_quantile_approx(field, q, sample_size=16))) <= TOL
    a = x if field == "x" else z
    assert _relmax(getattr(tds, f"{field}_var")(), a.var(axis=0, ddof=1)) <= 1e-13
    with pytest.raises(ValueError, match="quantile level"):
        getattr(tds, f"{field}_quantile")(1.5)


def test_batches_counts_and_indexing_as_jax():
    x, z = _data(23)
    jds, tds = _both(x, z, (9,))
    for kw in (dict(batch_size=5, shuffle=False), dict(batch_size=5, shuffle=False, drop_last=True),
               dict(batch_size=None, shuffle=False)):
        jl, tl = jdl.DataLoader(jds, **kw), tdl.DataLoader(tds, **kw)
        assert len(tl) == len(jl) and repr(tl) == repr(jl)
        _same_batches(list(jl), list(tl))
    tl = tdl.DataLoader(tds, batch_size=5, shuffle=False)
    assert len(tl) == 5 and list(tl)[-1][0].shape[0] == 3
    assert all(b[0].shape[0] == 5 for b in tdl.DataLoader(tds, 5, shuffle=False, drop_last=True))
    jl = jdl.DataLoader(jds, batch_size=4, shuffle=False)
    tl = tdl.DataLoader(tds, batch_size=4, shuffle=False)
    _same_batches([jl[1], jl[-1]], [tl[1], tl[-1]])
    _same_batches(jl[1:4], tl[1:4])
    np.testing.assert_array_equal(_np(tl[1][0]), x[4:8])
    with pytest.raises(IndexError):
        tl[6]
    with pytest.raises(TypeError):
        tl[1.0]
    with pytest.raises(RuntimeError):
        tdl.DataLoader(tds, batch_size=4, shuffle=True)[0]
    with pytest.raises(ValueError, match="positive"):
        tdl.DataLoader(tds, batch_size=0)


@pytest.mark.parametrize("drop_last", (False, True))
def test_shuffled_epochs_bitwise_as_jax(drop_last):
    """The same seed and epoch give the same batches, index for index:
    two epochs of a shuffled, sharded loader, set_epoch, infinite cycling."""
    x, z = _data(26)
    jds, tds = _both(x, z, (10, 17))
    jl = jdl.DataLoader(jds, batch_size=4, shuffle=True, seed=7, drop_last=drop_last)
    tl = tdl.DataLoader(tds, batch_size=4, shuffle=True, seed=7, drop_last=drop_last)
    for _epoch in range(2):
        _same_batches(list(jl), list(tl))
    jl.set_epoch(5)
    tl.set_epoch(5)
    _same_batches(list(jl), list(tl))
    tl.set_epoch(5)
    again = list(tl)
    tl.set_epoch(5)
    _same_batches([(a.numpy(), b.numpy()) for a, b in again], list(tl))
    ji = iter(jdl.DataLoader(jds, batch_size=4, shuffle=True, seed=1, infinite=True))
    ti = iter(tdl.DataLoader(tds, batch_size=4, shuffle=True, seed=1, infinite=True))
    _same_batches([next(ji) for _ in range(9)], [next(ti) for _ in range(9)])


def test_reduce_mean_and_stat_properties_as_jax():
    x, z = _data(10)
    jds, tds = _both(x, z, (3,))
    jl = jdl.DataLoader(jds, batch_size=4, shuffle=True, seed=2)
    tl = tdl.DataLoader(tds, batch_size=4, shuffle=True, seed=2)
    tm = tl.reduce_mean(lambda xb, zb: torch.stack([tgnp.mean(zb), tgnp.sum(xb)]))
    jm = jl.reduce_mean(lambda xb, zb: jgnp.stack([jgnp.mean(zb), jgnp.sum(xb)]))
    assert _relmax(tm, np.asarray(jm)) <= TOL
    assert abs(float(tdl.DataLoader(tds, 4, shuffle=False).reduce_mean(
        lambda xb, zb: tgnp.mean(zb))) - z.mean()) <= 1e-12 * abs(z.mean())
    for name in ("dataset_x_mean", "dataset_z_std", "dataset_x_min", "dataset_z_median"):
        assert _relmax(getattr(tl, name)(), np.asarray(getattr(jl, name)())) <= TOL


@pytest.mark.parametrize("scaler", ("Normalizer", "RobustScaler", "MinMaxScaler",
                                    "ObservationScaler"))
def test_scalers_as_jax_with_population_std(scaler):
    x, _ = _data(50, 4)
    x[:, 3] = 2.0  # a constant column: its spread is taken as 1
    z = np.random.default_rng(0).normal(size=50)
    a = z if scaler == "ObservationScaler" else x
    before = a.copy()
    st = getattr(tdl, scaler).fit(a)
    sj = getattr(jdl, scaler).fit(jgnp.asarray(a))
    at = st.transform(a)
    assert isinstance(at, torch.Tensor)
    assert _relmax(at, np.asarray(sj.transform(jgnp.asarray(a)))) <= TOL
    back = st.inverse_transform(at)
    np.testing.assert_allclose(_np(back), a, rtol=1e-10, atol=1e-12)
    if scaler == "Normalizer":
        np.testing.assert_allclose(_np(st.std)[0, :3], x[:, :3].std(axis=0, ddof=0),
                                   rtol=1e-14)
        assert _np(st.std)[0, 3] == 1.0 and _relmax(st.mean, np.asarray(sj.mean)) <= TOL
    if scaler == "ObservationScaler":
        assert abs(float(st.std) - z.std(ddof=0)) <= 1e-14 * z.std()
    # the caller's array is left as it was, and shares no memory with the results
    at.add_(1.0)
    back.add_(1.0)
    np.testing.assert_array_equal(a, before)


def test_dataset_does_not_alias_the_callers_array():
    x, z = _data(12)
    x0, z0 = x.copy(), z.copy()
    for ds in (tdl.Dataset(x, z), tdl.Dataset([x[:5], x[5:]], [z[:5], z[5:]]),
               tgp.interop.dataset_from_numpy(x, z, device="cpu", dtype=torch.float64)):
        for s in ds.x_list + ds.z_list:
            s.mul_(-3.0)
        xb, zb = next(iter(tdl.DataLoader(ds, 4, shuffle=False)))
        xb.add_(1.0)
        np.testing.assert_array_equal(x, x0)
        np.testing.assert_array_equal(z, z0)
    with pytest.raises(TypeError, match="numpy"):
        tgp.interop.dataset_from_numpy(torch.zeros(3, 2), np.zeros(3), device="cpu",
                                       dtype=torch.float64)


def test_collate_and_stacked_batches_as_jax():
    x, z = _data(34, 2)
    jds, tds = _both(x, z, (13,))
    jl = jdl.DataLoader(jds, batch_size=8, shuffle=False)
    tl = tdl.DataLoader(tds, batch_size=8, shuffle=False)
    _same_batches([jdl.collate_batches(list(jl))], [tdl.collate_batches(list(tl))])
    np.testing.assert_array_equal(_np(tdl.collate_batches(list(tl))[0]), x)
    with pytest.raises(ValueError):
        tdl.collate_batches([])
    jxb, jzb = jl.as_stacked_batches()
    txb, tzb = tl.as_stacked_batches()
    assert tuple(txb.shape) == (4, 8, 2) and tuple(tzb.shape) == (4, 8)
    np.testing.assert_array_equal(_np(txb), np.asarray(jxb))
    np.testing.assert_array_equal(_np(tzb), np.asarray(jzb))
    txb1, _ = tl.as_stacked_batches(mesh=tgp.parallel.make_mesh(1))
    np.testing.assert_array_equal(_np(txb1), _np(txb))
