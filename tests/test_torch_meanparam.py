# tests/test_torch_meanparam.py
"""A NumPy ``meanparam`` through the criteria that read ``model.meanparam``.

gpmp_tpu takes ``meanparam`` as a NumPy array, because ``jnp`` converts it
where the mean function multiplies it with an array.  The port converts it
(``core.utils.meanparam_of``) at the sites that hand it to ``model.mean``:
the profiled and contrast REML, ``norm_k_sqrd`` and the sharded REML, and
so ``anisotropic_parameters_initial_guess`` and
``select_parameters_with_reml`` too.  A model with meantype 'parameterized'
and mean ``p * ones((n, 1))`` (the mean parameter enters the REML's
design), ``meanparam=np.array([0.4])``, at n = 80, d = 3, Matern p = 2, on
the CPU in f64: each entry point matches gpmp_tpu (jitted) to 1e-12
relative, and the fit is compared at the criterion's flatness (the two
SLSQP runs land ~1e-7 apart in the parameters and agree on the criterion
to 1e-9).
"""

import jax
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.kernel  # noqa: F401
import gpmp_tpu.num as jgnp
from gpmp_tpu.parallel import make_mesh as jmake_mesh
from gpmp_tpu.parallel.likelihood import (
    sharded_negative_log_restricted_likelihood as j_sharded_reml,
)
import gpmp_tpu_torch as tgp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config
from gpmp_tpu_torch.parallel import make_mesh, sharded_negative_log_restricted_likelihood

TOL = 1e-12


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _relmax(a, b):
    a = np.asarray(tgnp.to_np(a), dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _data(n=80, d=3, seed=16):
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(n, d))
    zi = np.sin(4.0 * xi[:, 0]) + 0.7 * xi[:, 1] ** 2 + 0.3 * xi[:, 2] + 0.05 * rng.normal(size=n)
    covparam = np.array([np.log(0.5)] + [np.log(1.0 / 0.3)] * d)
    return xi, zi, covparam


def _models(covparam=None):
    def mean(gnp):
        def m(x, param):
            return param * gnp.ones((x.shape[0], 1))
        return m

    def jkernel(x, y, c, pairwise=False):
        return jgp.kernel.maternp_covariance(x, y, 2, c, pairwise)

    def tkernel(x, y, c, pairwise=False):
        return tgp.kernel.maternp_covariance(x, y, 2, c, pairwise)

    mp = np.array([0.4])
    return (jgp.Model(mean(jgnp), jkernel, mp, covparam, meantype="parameterized"),
            tgp.Model(mean(tgnp), tkernel, mp, covparam, meantype="parameterized"))


_CALLS = {
    "reml profiled": lambda m, xi, zi, c: m.negative_log_restricted_likelihood(c, xi, zi),
    "reml contrast": lambda m, xi, zi, c: m.negative_log_restricted_likelihood(
        c, xi, zi, impl="contrast"),
    "norm_k_sqrd": lambda m, xi, zi, c: m.norm_k_sqrd(xi, zi, c),
    "initial guess": lambda m, xi, zi, c: m._gp.kernel.anisotropic_parameters_initial_guess(
        m, xi, zi),
}


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_numpy_meanparam_entry_points(name):
    xi, zi, cp = _data()
    call = _CALLS[name]
    jm, tm = _models(cp)
    jm._gp, tm._gp = jgp, tgp
    jout = jax.jit(lambda: call(jm, xi, zi, cp))()
    tout = call(tm, xi, zi, cp)
    assert isinstance(tout, torch.Tensor)
    assert np.all(np.isfinite(tgnp.to_np(tout)))
    assert _relmax(tout, jout) <= TOL


def test_numpy_meanparam_sharded_reml():
    xi, zi, cp = _data()
    jm, tm = _models()
    jv = jax.jit(lambda c: j_sharded_reml(jm, c, xi, zi, jmake_mesh(1, axis_name="shard"),
                                          block=40))(cp)
    tv = sharded_negative_log_restricted_likelihood(tm, cp, xi, zi,
                                                    make_mesh(1, axis_name="shard"), block=40)
    assert _relmax(tv, jv) <= TOL


def test_numpy_meanparam_reml_fit():
    xi, zi, _ = _data()
    jm, tm = _models()
    jm, jinfo = jgp.kernel.select_parameters_with_reml(jm, xi, zi, info=True)
    tm, tinfo = tgp.kernel.select_parameters_with_reml(tm, xi, zi, info=True)
    assert np.isfinite(tinfo.fun)
    assert abs(tinfo.fun - jinfo.fun) <= 1e-9 * abs(jinfo.fun)
    np.testing.assert_allclose(tgnp.to_np(tm.covparam), np.asarray(jm.covparam), atol=1e-5)
    # each package's optimum, read through the other's criterion
    cross = float(jm.negative_log_restricted_likelihood(tgnp.to_np(tm.covparam), xi, zi))
    assert abs(cross - jinfo.fun) <= 1e-9 * abs(jinfo.fun)
