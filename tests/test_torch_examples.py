# tests/test_torch_examples.py
"""The port's example twins (03, 04, 07, 20 and 30; 02 is in
test_torch_diagnosis.py) run at tests/test_examples.py's reduced sizes on the
CPU, beside gpmp_tpu's examples: the fits agree at the criterion's flatness
(the criteria to 1e-9; two SLSQP runs land ~1e-7 apart in the parameters),
and the RMSEs the examples return to 1e-6.  Example 20 returns the REMAP
fits' covparams, one row a draw (its criteria are in its printed lines);
example 30 is the batched REMAP fit through a DataLoader."""

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
