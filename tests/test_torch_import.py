# tests/test_torch_import.py
"""gpmp_tpu_torch imports alone (no JAX), pins TF32 off, and picks its
device and Cholesky engine as configured."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpmp_tpu_torch
from gpmp_tpu_torch import config, interop


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBMODULES = (
    "gpmp_tpu_torch.config",
    "gpmp_tpu_torch.num",
    "gpmp_tpu_torch.ops",
    "gpmp_tpu_torch.ops.gram",
    "gpmp_tpu_torch.ops.mixed",
    "gpmp_tpu_torch.ops._build",
    "gpmp_tpu_torch.ops.distance",
    "gpmp_tpu_torch.ops.refine",
    "gpmp_tpu_torch.ops.streamed",
    "gpmp_tpu_torch.ops.chol",
    "gpmp_tpu_torch.kernel",
    "gpmp_tpu_torch.kernel.matern",
    "gpmp_tpu_torch.kernel.exponential",
    "gpmp_tpu_torch.kernel.init",
    "gpmp_tpu_torch.kernel.utils",
    "gpmp_tpu_torch.kernel.parameter_selection",
    "gpmp_tpu_torch.kernel.bounds",
    "gpmp_tpu_torch.kernel.priors",
    "gpmp_tpu_torch.kernel.prior_defaults",
    "gpmp_tpu_torch.kernel.prior_helpers",
    "gpmp_tpu_torch.dataloader",
    "gpmp_tpu_torch.core",
    "gpmp_tpu_torch.core.model",
    "gpmp_tpu_torch.core.kriging",
    "gpmp_tpu_torch.core.likelihood",
    "gpmp_tpu_torch.core.linalg",
    "gpmp_tpu_torch.core.loo",
    "gpmp_tpu_torch.core.sample_paths",
    "gpmp_tpu_torch.core.utils",
    "gpmp_tpu_torch.core.fisher",
    "gpmp_tpu_torch.misc",
    "gpmp_tpu_torch.misc.designs",
    "gpmp_tpu_torch.misc.testfunctions",
    "gpmp_tpu_torch.misc.dataframe",
    "gpmp_tpu_torch.misc.scoringrules",
    "gpmp_tpu_torch.parameter",
    "gpmp_tpu_torch.parameter.param",
    "gpmp_tpu_torch.modeldiagnosis",
    "gpmp_tpu_torch.modeldiagnosis.un1ddist",
    "gpmp_tpu_torch.modeldiagnosis.utils",
    "gpmp_tpu_torch.modeldiagnosis.param_stats",
    "gpmp_tpu_torch.modeldiagnosis.performance",
    "gpmp_tpu_torch.modeldiagnosis.report",
    "gpmp_tpu_torch.interop",
    "gpmp_tpu_torch.parallel",
    "gpmp_tpu_torch.parallel.mesh",
    "gpmp_tpu_torch.parallel.likelihood",
    "gpmp_tpu_torch.parallel.streamed",
    "gpmp_tpu_torch.parallel.view",
    "gpmp_tpu_torch.parallel.chol",
    "gpmp_tpu_torch.parallel.mixed",
    "gpmp_tpu_torch.parallel.predict",
    "gpmp_tpu_torch.parallel.loo",
    "gpmp_tpu_torch.parallel.batched",
)


def _run(code, **env):
    full_env = {k: v for k, v in os.environ.items() if not k.startswith("GPMP_")}
    full_env["GPMP_DEVICE"] = "cpu"
    full_env.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full_env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {SUBMODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import gpmp_tpu_torch as gp\n"
        "assert gp.Model is gp.core.Model\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'gpmp_tpu.')) or m == 'gpmp_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# the example twins, and the modules that import matplotlib
EXAMPLE_TWINS = (
    "examples.gpmp_tpu_torch_example02_1d_interpolation",
    "examples.gpmp_tpu_torch_example03_2d",
    "examples.gpmp_tpu_torch_example04_nd",
    "examples.gpmp_tpu_torch_example07_nd_regression",
    "examples.gpmp_tpu_torch_example20_1d_interpolation_variation_remap",
    "examples.gpmp_tpu_torch_example30_dataloader",
)
PLOTTING = ("gpmp_tpu_torch.plot", "gpmp_tpu_torch.plot.plotutils",
            "gpmp_tpu_torch.modeldiagnosis.plotting")


def test_import_pulls_no_matplotlib():
    """Only the plotting modules import matplotlib (an installation without
    it must run the rest): the package, its diagnosis, Fisher and the
    example twins do not;
    the plotting names of modeldiagnosis load it when asked for, and the
    plotting modules pull no JAX either."""
    code = (
        "import importlib, sys\n"
        f"for name in {SUBMODULES + EXAMPLE_TWINS!r}:\n"
        "    importlib.import_module(name)\n"
        "import gpmp_tpu_torch as gp\n"
        "assert gp.modeldiagnosis.diag and gp.parameter.Param and gp.core.fisher\n"
        "assert 'matplotlib' not in sys.modules\n"
        "import matplotlib; matplotlib.use('Agg')\n"
        "assert callable(gp.modeldiagnosis.plot_selection_criterion_crosssections)\n"
        f"for name in {PLOTTING!r}:\n"
        "    importlib.import_module(name)\n"
        "assert gp.plot.Figure\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'gpmp_tpu.')) or m == 'gpmp_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_tf32_pins_hold():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_default_device_is_cpu_and_cuda_needs_a_card(monkeypatch):
    """The default device is the card; without one, the first tensor raises
    unless the CPU was asked for (name kept from when the CPU was the
    default)."""
    import gpmp_tpu_torch.num as gnp

    assert config._GPmpTorchConfig().device == "cuda"
    monkeypatch.setattr(config.get_config(), "device", "cuda")
    if torch.cuda.is_available():
        assert config.get_device().type == "cuda"
        assert gnp.zeros(3).is_cuda
    else:
        with pytest.raises(RuntimeError, match="set_device\\('cpu'\\)"):
            gnp.zeros(3)
        with pytest.raises(RuntimeError, match="cuda"):
            config.set_device("cuda")
    config.set_device("cpu")
    assert config.get_device() == torch.device("cpu")
    assert gnp.zeros(3).device.type == "cpu"


def test_env_device_cuda_without_card_raises_at_import():
    proc = _run("import torch, gpmp_tpu_torch\n"
                "print(torch.cuda.is_available())", GPMP_DEVICE="cuda")
    if proc.returncode == 0:
        assert proc.stdout.strip() == "True"  # a card is there
    else:
        assert "torch.cuda.is_available() is False" in proc.stderr


def test_set_chol_engine():
    with pytest.raises(ValueError):
        config.set_chol_engine("bogus")
    for name in ("mixed", "f64", "auto"):
        config.set_chol_engine(name)
        assert config.get_chol_engine() == name


def test_dtype_is_float64_by_default():
    import gpmp_tpu_torch.num as gnp

    assert gnp.get_dtype() == torch.float64
    assert gnp.eps == float(np.finfo(np.float64).eps)
    with pytest.raises(RuntimeError):
        config.set_dtype("float32")


def test_params_from_numpy():
    cp, mp = interop.params_from_numpy(np.array([0.5, -1.0, 2.0]), None,
                                       device="cpu", dtype=torch.float64)
    assert mp is None
    assert cp.dtype == torch.float64 and cp.device.type == "cpu"
    np.testing.assert_array_equal(cp.numpy(), [0.5, -1.0, 2.0])
    cp, mp = interop.params_from_numpy(np.array([[1.0, 2.0]]), np.array(3.0),
                                       device="cpu", dtype=torch.float32)
    assert cp.shape == (2,) and mp.shape == (1,) and mp.dtype == torch.float32
    with pytest.raises(TypeError):
        interop.params_from_numpy(torch.zeros(2), device="cpu", dtype=torch.float64)


def test_unported_options_raise():
    """The refusals of the selection procedures' options (name kept from when
    lbfgs-device and dataloader sources were not ported: they are now,
    tests/test_torch_remap.py): exactly one data source, arrays or a
    dataloader; a mesh of make_mesh only."""
    gp = gpmp_tpu_torch
    model = gp.Model(lambda x, p: torch.ones((x.shape[0], 1), dtype=torch.float64),
                     lambda x, y, c, pairwise=False: None)
    xi = np.zeros((3, 1))
    zi = np.zeros(3)
    with pytest.raises(ValueError, match="not both"):
        gp.kernel.select_parameters_with_reml(model, xi, zi, dataloader=object(),
                                              covparam0=np.zeros(2))
    # any make_mesh mesh is taken now (one card, or a process group's ranks:
    # tests/test_torch_mesh.py); anything else is refused
    with pytest.raises(TypeError, match="mesh"):
        gp.kernel.select_parameters_with_reml(model, xi, zi, covparam0=np.zeros(2),
                                              mesh=object())
    with pytest.raises(ValueError, match=r"Provide either \(xi, zi\) or dataloader\.$"):
        gp.kernel.select_parameters_with_reml(model, xi, covparam0=np.zeros(2))
