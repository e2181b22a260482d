# tests/test_torch_examples.py
"""The port's example twins (03, 04, 07, 20, 23 and 30; 02 is in
test_torch_diagnosis.py) run at tests/test_examples.py's reduced sizes on the
CPU, beside gpmp_tpu's examples: the fits agree at the criterion's flatness
(the criteria to 1e-9; two SLSQP runs land ~1e-7 apart in the parameters),
and the RMSEs the examples return to 1e-6.  Example 20 returns the REMAP
fits' covparams, one row a draw (its criteria are in its printed lines);
example 30 is the batched REMAP fit through a DataLoader.  Example 23
samples the REMAP posterior with MH and NUTS: the two packages draw
different random numbers, so its posterior means are held to each other
within 4 Monte Carlo standard errors (batch means of both runs)."""

import contextlib
import importlib
import io
import os
import sys

import numpy as np
import pytest
import torch

import gpmp_tpu_torch.num as tgnp
from gpmp_tpu_torch import config

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


# (example, main's keyword arguments, what main returns)
CASES = {
    "03_2d": ({}, ("model", "rmse")),
    "04_nd": (dict(ni=60, nt=200), ("model", "info")),
    "07_nd_regression": (dict(problem=1), ("model", "info", "rmse")),
    "20_1d_interpolation_variation_remap": (dict(n_repeat=2), None),
    "30_dataloader": (dict(ni=400, batch_size=100), ("model", "info")),
}


def _run(package, name, kwargs):
    mod = importlib.import_module(f"examples.{package}_example{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(show=False, **kwargs)
    keys = CASES[name][1]
    return (dict(zip(keys, out)) if keys else {"covparams": out}), buf.getvalue()


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_twin_matches_jax(name):
    kwargs = CASES[name][0]
    t, tout = _run("gpmp_tpu_torch", name, kwargs)
    j, jout = _run("gpmp_tpu", name, kwargs)
    if "covparams" in t:
        np.testing.assert_allclose(t["covparams"], j["covparams"], atol=1e-4)
    else:
        assert isinstance(t["model"].covparam, torch.Tensor)
        np.testing.assert_allclose(tgnp.to_np(t["model"].covparam),
                                   np.asarray(j["model"].covparam), atol=1e-4)
    if "info" in t:
        assert abs(t["info"].fun - j["info"].fun) <= 1e-9 * abs(j["info"].fun)
    if "rmse" in t:
        assert abs(t["rmse"] - j["rmse"]) <= 1e-6 * j["rmse"]
    # the same report and performance tables (the fit's time aside)
    keep = [line for line in tout.splitlines() if not line.strip().startswith("time:")]
    assert keep == [line for line in jout.splitlines() if not line.strip().startswith("time:")]


EX23_KWARGS = dict(n_steps_total=600, burnin=300, num_samples=80, num_warmup=60)


def _batch_means_se(chains, n_batches):
    """Posterior mean and its Monte Carlo standard error from batch means:
    chains (C, T, d), each cut into n_batches consecutive batches."""
    C, T, d = chains.shape
    b = T // n_batches
    means = chains[:, : b * n_batches].reshape(C * n_batches, b, d).mean(axis=1)
    return chains.reshape(-1, d).mean(axis=0), means.std(axis=0, ddof=1) / np.sqrt(len(means))


def test_example23_twin_posterior_within_mc_error():
    import gpmp_tpu as jgp
    import gpmp_tpu.num as jgnp
    import gpmp_tpu_torch as tgp

    name = "examples.{}_example23_1d_interpolation_posterior_sampling"
    outs = {}
    for package in ("gpmp_tpu_torch", "gpmp_tpu"):
        mod = importlib.import_module(name.format(package))
        with contextlib.redirect_stdout(io.StringIO()):
            s_mh, s_nuts = mod.main(show=False, **EX23_KWARGS)
        outs[package] = (np.asarray(s_mh).reshape(2, -1, 2), np.asarray(s_nuts).reshape(2, -1, 2))
        # the example's REMAP fit, on its data
        gp, gnp = (tgp, tgnp) if package == "gpmp_tpu_torch" else (jgp, jgnp)
        xi = gp.misc.designs.ldrandunif(1, 10, [[-1], [1]], seed=0)
        zi = gp.misc.testfunctions.twobumps(xi)
        _, info = gp.kernel.select_parameters_with_remap(
            gp.Model(mod.constant_mean, mod.kernel), xi, zi, info=True)
        outs[package + " map"] = np.asarray(gnp.to_np(info["covparam"]), dtype=float)
    np.testing.assert_allclose(outs["gpmp_tpu_torch map"], outs["gpmp_tpu map"], atol=1e-4)
    for k, (sampler, n_batches) in enumerate((("MH", 10), ("NUTS", 8))):
        t, j = outs["gpmp_tpu_torch"][k], outs["gpmp_tpu"][k]
        assert t.shape == j.shape and np.all(np.isfinite(t))
        m_t, se_t = _batch_means_se(t, n_batches)
        m_j, se_j = _batch_means_se(j, n_batches)
        se = np.sqrt(se_t**2 + se_j**2)
        assert np.all(np.abs(m_t - m_j) <= 4.0 * se), (sampler, m_t, m_j, se)
