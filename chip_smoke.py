#!/usr/bin/env python3
"""Smoke test of gpmp_tpu_torch on one CUDA card: REML fit + predict.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc, and the repository's sources; it imports
neither JAX nor gpmp_tpu.  Phases (each prints lines; any failure exits
non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), the
   time to build gpmp_tpu_torch/csrc with nvcc, ptxas register/spill lines.
2. Kernels vs plain versions on the card: K1 (Matern gram) and K2 (its
   parameter pullback) in float64 and float32 against the plain PyTorch
   versions on the same CUDA tensors, (n, m, d) in {(1000, 1000, 6) same,
   (1000, 1000, 6) cross, (997, 503, 3) cross}, p in {0, 1, 2, 3}, with
   duplicated rows.  Errors are max|kernel - plain| / max|plain|;
   tolerances K1 1e-12 (f64) / 1e-5 (f32), K2 1e-9 (f64) / 1e-3 (f32).
3. The main path: Hartmann6, n = 1000, d = 6, Matern p = 2, constant
   mean; select_parameters_with_reml then predict at nt = 1000 points, on
   the card, with the launch counters reset just before and the plain
   versions made to raise on CUDA tensors.  Checks: both kernels launched,
   finite covparam and predictions, and the port on the CPU (plain
   versions) at the card's covparam agrees to rel 1e-8 on the REML value
   and on the predicted mean and variance.
4. Times on the card (CUDA events / synchronised host clock): K1 and K2 vs
   their plain versions at the main path's shapes; REML value+grad evals/s
   at n = 1000 and 8192 (kernels and plain gram); fit+predict wall-clock.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BOX6 = [[0.0] * 6, [1.0] * 6]
DEVICE = "cuda"
TOL_K1 = {"float64": 1e-12, "float32": 1e-5}
TOL_K2 = {"float64": 1e-9, "float32": 1e-3}
TOL_PATH = 1e-8
EVAL_SIZES = ((1000, 30), (8192, 10))  # (n, evaluations) for the evals/s rates


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def rel_err(a, b):
    """max|a - b| / max|b|, as a Python float."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def say(*parts):
    print(*parts, flush=True)


# ----------------------------------------------------------------------------
def phase_device_and_build(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    say(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device0 {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    t_build = time.perf_counter() - t0
    say(f"[phase 1] kernels built/loaded in {t_build:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'} s) "
        f"from {build.build_dir()}")
    log = (build.build_dir() / "ptxas.log").read_text() if (
        build.build_dir() / "ptxas.log").exists() else ""
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("[ptxas] " + line.strip())
    return card


def _inputs(torch, n, m, d, dtype, seed, same):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[10:20] = x[0:10]  # duplicated rows: h = 0 off the diagonal
    if same:
        y = x
    else:
        y = rng.uniform(size=(m, d))
        y[:5] = x[:5]  # coincident x/y points
    theta = np.concatenate([[0.3], rng.uniform(-0.5, 1.5, size=d)])
    kbar = rng.normal(size=(n, m))
    dev = torch.device(DEVICE)
    xt = torch.as_tensor(x, dtype=dtype, device=dev)
    yt = xt if same else torch.as_tensor(y, dtype=dtype, device=dev)
    return (xt, yt, torch.as_tensor(theta, dtype=dtype, device=dev),
            torch.as_tensor(kbar, dtype=dtype, device=dev))


def phase_kernels_vs_plain(torch, gram):
    cases = [(1000, 1000, 6, True), (1000, 1000, 6, False), (997, 503, 3, False)]
    worst = {}
    main_abs = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for ci, (n, m, d, same) in enumerate(cases):
            for p in (0, 1, 2, 3):
                x, y, theta, kbar = _inputs(torch, n, m, d, dtype, 100 + ci, same)
                K = gram.matern_gram_cuda(x, y, p, theta, same)
                Kp = gram.matern_gram_plain(x, y, p, theta, same)
                th = theta.clone().requires_grad_(True)
                (gp_,) = torch.autograd.grad(
                    torch.sum(gram.matern_gram_plain(x, y, p, th, same) * kbar), th)
                g = gram.matern_gram_pullback_cuda(kbar, x, y, p, theta, same)
                torch.cuda.synchronize()
                e1 = rel_err(K, Kp)
                e2 = rel_err(g, gp_.double())
                e2_el = float(((g - gp_.double()).abs()
                               / gp_.double().abs().clamp_min(1e-300)).max())
                tag = f"{dname} n={n} m={m} d={d} {'same' if same else 'cross'} p={p}"
                say(f"[phase 2] {tag}: K1 rel {e1:.3e}  K2 rel {e2:.3e} "
                    f"(componentwise {e2_el:.3e})")
                check(torch.isfinite(K).all().item(), f"K1 non-finite: {tag}")
                check(torch.isfinite(g).all().item(), f"K2 non-finite: {tag}")
                check(e1 <= TOL_K1[dname], f"K1 {tag}: rel {e1:.3e} > {TOL_K1[dname]}")
                check(e2 <= TOL_K2[dname], f"K2 {tag}: rel {e2:.3e} > {TOL_K2[dname]}")
                for key, val in (("K1", e1), ("K2", e2)):
                    worst[(key, dname)] = max(worst.get((key, dname), 0.0), val)
                if dname == "float64" and ci == 0 and p == 2:
                    main_abs["K1"] = float((K - Kp).abs().max())
                    main_abs["K2"] = float((g - gp_).abs().max())
    # K2 reproducibility: same inputs, bitwise same gradient
    x, y, theta, kbar = _inputs(torch, 1000, 1000, 6, torch.float64, 100, True)
    g1 = gram.matern_gram_pullback_cuda(kbar, x, y, 2, theta, True)
    g2 = gram.matern_gram_pullback_cuda(kbar, x, y, 2, theta, True)
    check(torch.equal(g1, g2), "K2 is not bitwise reproducible")
    for (key, dname), val in sorted(worst.items()):
        say(f"[phase 2] worst {key} {dname} rel err {val:.3e}")
    return main_abs


# ----------------------------------------------------------------------------
def _problem(gp, n, nt, design="ldrandunif"):
    make = getattr(gp.misc.designs, design)
    xi = make(6, n, BOX6, seed=0)
    zi = gp.misc.testfunctions.hartmann6(xi)
    xt = make(6, nt, BOX6, seed=1)
    zt = gp.misc.testfunctions.hartmann6(xt)
    return xi, zi, xt, zt


def _model(gp, gnp, covparam=None):
    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 2, covparam, pairwise)

    return gp.Model(constant_mean, kernel, covparam=covparam)


def _fit_predict(gp, gnp, torch, xi, zi, xt):
    model = _model(gp, gnp)
    t0 = time.perf_counter()
    model, info = gp.kernel.select_parameters_with_reml(model, xi, zi, info=True)
    zpm, zpv = model.predict(xi, zi, xt)
    torch.cuda.synchronize()
    return model, info, zpm, zpv, time.perf_counter() - t0


class _PlainGuard:
    """Makes the plain versions raise on CUDA tensors while active."""

    def __init__(self, gram):
        self.gram = gram
        self.saved = {}

    def __enter__(self):
        for name in ("matern_gram_plain", "matern_gram_pullback_plain"):
            orig = getattr(self.gram, name)
            self.saved[name] = orig

            def guarded(*args, _orig=orig, _name=name, **kw):
                if any(getattr(a, "is_cuda", False) for a in args):
                    raise AssertionError(f"{_name} reached with CUDA tensors")
                return _orig(*args, **kw)

            setattr(self.gram, name, guarded)
        return self

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            setattr(self.gram, name, orig)


def phase_main_path(gp, gnp, gram, torch):
    xi, zi, xt, zt = _problem(gp, 1000, 1000)
    gp.config.set_device(DEVICE)
    gram.K1_LAUNCHES = 0
    gram.K2_LAUNCHES = 0
    with _PlainGuard(gram):
        model, info, zpm, zpv, t_fp = _fit_predict(gp, gnp, torch, xi, zi, xt)
    launches = {"K1": gram.K1_LAUNCHES, "K2": gram.K2_LAUNCHES}
    say(f"[phase 3] main path launches {launches}; fit+predict (first) {t_fp:.3f} s; "
        f"nfev {info.nfev}; REML {info.fun!r}")
    check(launches["K1"] > 0, "K1 was not launched on the main path")
    check(launches["K2"] > 0, "K2 was not launched on the main path")
    check(model.covparam.device.type == DEVICE, "covparam is not on the card")
    covparam = gnp.to_np(model.covparam)
    say(f"[phase 3] covparam {covparam.tolist()}")
    check(np.all(np.isfinite(covparam)), "covparam not finite")
    check(zpm.shape == (1000,) and zpv.shape == (1000,), "prediction shapes")
    check(np.all(np.isfinite(zpm)) and np.all(np.isfinite(zpv)), "predictions not finite")
    rmse = float(np.sqrt(np.mean((zpm - zt) ** 2)))
    say(f"[phase 3] RMSE vs hartmann6 {rmse:.4e} (std(zt) {float(np.std(zt)):.4e})")
    check(rmse < np.std(zt), "RMSE is not below the spread of the test values")

    xi_c, zi_c = gnp.asarray(xi), gnp.asarray(zi)
    v_gpu = float(model.negative_log_restricted_likelihood(model.covparam, xi_c, zi_c))
    gp.config.set_device("cpu")
    try:
        model_cpu = _model(gp, gnp, covparam=covparam)
        xi_h, zi_h = gnp.asarray(xi), gnp.asarray(zi)
        v_cpu = float(model_cpu.negative_log_restricted_likelihood(
            gnp.asarray(covparam), xi_h, zi_h))
        zpm_c, zpv_c = model_cpu.predict(xi, zi, xt)
    finally:
        gp.config.set_device(DEVICE)
    e_v = abs(v_gpu - v_cpu) / abs(v_cpu)
    e_m = float(np.max(np.abs(zpm - zpm_c)) / np.max(np.abs(zpm_c)))
    e_s = float(np.max(np.abs(zpv - zpv_c)) / np.max(np.abs(zpv_c)))
    say(f"[phase 3] card vs CPU at the card's covparam: REML rel {e_v:.3e}, "
        f"mean rel {e_m:.3e}, variance rel {e_s:.3e} (tol {TOL_PATH})")
    check(e_v <= TOL_PATH, f"REML card vs CPU rel {e_v:.3e}")
    check(e_m <= TOL_PATH, f"predict mean card vs CPU rel {e_m:.3e}")
    check(e_s <= TOL_PATH, f"predict variance card vs CPU rel {e_s:.3e}")
    return launches, (xi, zi, xt), t_fp


# ----------------------------------------------------------------------------
def _time_cuda(torch, fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _evals_per_s(gp, gnp, torch, n, reps):
    # a uniform design: the low-discrepancy search costs O(n^2) per try
    xi, zi, _, _ = _problem(gp, n, 1, design="randunif")
    model = _model(gp, gnp)
    crit, _, _, _ = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    rng = np.random.default_rng(5)
    p0 = np.concatenate([[math.log(float(np.var(zi)))],
                         -np.log(0.3 * np.ones(6))])
    crit(p0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        v = crit(p0 + 1e-3 * rng.standard_normal(p0.shape))
        if not math.isfinite(v):
            fail(f"criterion not finite at n={n}")
    return reps / (time.perf_counter() - t0)


def phase_times(gp, gnp, gram, torch, main_data):
    times = {}
    x, _, theta, kbar = _inputs(torch, 1000, 1000, 6, torch.float64, 7, True)
    kb = (kbar + kbar.T) / 2
    times["K1"] = (
        _time_cuda(torch, lambda: gram.matern_gram_cuda(x, x, 2, theta, True), 200),
        _time_cuda(torch, lambda: gram.matern_gram_plain(x, x, 2, theta, True), 50),
    )
    times["K2"] = (
        _time_cuda(torch, lambda: gram.matern_gram_pullback_cuda(kb, x, x, 2, theta, True), 200),
        _time_cuda(torch, lambda: gram.matern_gram_pullback_plain(kb, x, x, 2, theta, True), 50),
    )
    for k, (t_k, t_p) in times.items():
        say(f"[phase 4] {k} n=m=1000 d=6 p=2 f64: kernel {t_k:.4f} ms, plain {t_p:.4f} ms")

    import gpmp_tpu_torch.kernel.matern as matern_mod

    rates = {}
    for n, reps in EVAL_SIZES:
        rates[(n, "kernels")] = _evals_per_s(gp, gnp, torch, n, reps)
        kernel_entry = matern_mod.matern_gram
        matern_mod.matern_gram = lambda x, y, p, theta, same=False: (
            gram.matern_gram_plain(x, y, p, theta, same))
        try:
            rates[(n, "plain")] = _evals_per_s(gp, gnp, torch, n, max(3, reps // 2))
        finally:
            matern_mod.matern_gram = kernel_entry
        say(f"[phase 4] REML value+grad n={n} d=6 f64: "
            f"{rates[(n, 'kernels')]:.2f} evals/s with K1/K2, "
            f"{rates[(n, 'plain')]:.2f} evals/s with the plain gram")

    xi, zi, xt = main_data
    _, info, _, _, t_fp = _fit_predict(gp, gnp, torch, xi, zi, xt)
    say(f"[phase 4] fit+predict n=1000 nt=1000 (warm) {t_fp:.3f} s, nfev {info.nfev}")
    return times, rates, t_fp


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import gpmp_tpu_torch as gp
        import gpmp_tpu_torch.kernel  # noqa: F401
        import gpmp_tpu_torch.misc  # noqa: F401
        import gpmp_tpu_torch.num as gnp
        from gpmp_tpu_torch.ops import _build as build
        from gpmp_tpu_torch.ops import gram
    except ImportError as exc:
        fail(f"cannot import gpmp_tpu_torch next to this script: {exc}")
    check("jax" not in sys.modules, "jax was imported")

    t_start = time.perf_counter()
    card = phase_device_and_build(torch, build)
    main_abs = phase_kernels_vs_plain(torch, gram)
    launches, main_data, t_first = phase_main_path(gp, gnp, gram, torch)
    times, rates, t_warm = phase_times(gp, gnp, gram, torch, main_data)
    check("jax" not in sys.modules, "jax was imported")

    say(json.dumps({
        "card": card,
        "fit_predict_s": {"first": t_first, "warm": t_warm},
        "reml_value_grad_evals_per_s": {f"n={n} {k}": v for (n, k), v in rates.items()},
        "total_s": time.perf_counter() - t_start,
    }))
    src = "gpmp_tpu_torch/csrc/matern_gram.cu"
    say(json.dumps({"kernels": [
        {"name": "K1 matern_gram", "route": "cuda", "source": src,
         "replaces": "gpmp_tpu/kernel/matern.py:69", "launches": launches["K1"],
         "max_abs_err": main_abs["K1"], "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K2 matern_gram_pullback", "route": "cuda", "source": src,
         "replaces": "gpmp_tpu/parallel/likelihood.py:225", "launches": launches["K2"],
         "max_abs_err": main_abs["K2"], "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
