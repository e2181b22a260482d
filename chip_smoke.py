#!/usr/bin/env python3
"""Smoke test of gpmp_tpu_torch on one CUDA card: REML fit + predict, noisy
REML fit + LOO + predict on the mixed Cholesky engine, and conditional
sample paths.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc, and the repository's sources; it imports
neither JAX nor gpmp_tpu.  Phases (each prints lines; any failure exits
non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), the
   time to build gpmp_tpu_torch/csrc with nvcc (one nvcc per source, in
   parallel), ptxas register/spill lines.
2. K1/K2 vs plain versions on the card: K1 (Matern gram) and K2 (its
   parameter pullback) in float64 and float32 against the plain PyTorch
   versions on the same CUDA tensors, (n, m, d) in {(1000, 1000, 6) same,
   (1000, 1000, 6) cross, (997, 503, 3) cross}, p in {0, 1, 2, 3}, with
   duplicated rows.  Errors are max|kernel - plain| / max|plain|;
   tolerances K1 1e-12 (f64) / 1e-5 (f32), K2 1e-9 (f64) / 1e-3 (f32).
2b. K3/K4/K5/K7 vs plain versions on the card, on noisy-Matern SPD
   matrices K (n in {1000, 1024, 4099}, cond(K) ~1e3 and ~1e6, set by the
   noise variance from the gram's largest eigenvalue), with the
   tolerances and reasons given at TOL_MIXED.
2c. K1d (scaled distance and its pullback, full and elementwise), K1m (the
   Matern polynomial and its backward), K7b (the LOO diagonal series, both
   branches) and K8s (the f64 sampling residual) vs their plain versions
   on the card: K1d/K1m at n in {1000, 4099}, d in {1, 6}, p in {0, 2, 3},
   with coincident points, in f64 and f32; K7b on phase 2b's inputs; K8s
   at n in {1000, 4099, 8192}, cond(K) ~1e3 and ~1e6; tolerances at
   TOL_2C.
3. The main path: Hartmann6, n = 1000, d = 6, Matern p = 2, constant
   mean; select_parameters_with_reml then predict at nt = 1000 points, on
   the card, with the launch counters reset just before and the plain
   versions made to raise on CUDA tensors.  Checks: both kernels launched,
   finite covparam and predictions, and the port on the CPU (plain
   versions) at the card's covparam agrees to rel 1e-8 on the REML value
   and on the predicted mean and variance.
3b. The noisy-regression slice on the mixed engine: bench.py's data
   (n = 1000, d = 6, seed 7, noise 0.1), its user kernel (Matern p = 2
   plus a noise variance) and its p0; under set_chol_engine("mixed"):
   autoselect_parameters on REML, Model.loo, then predict at nt = 1000
   seeded uniform points, with the K1d/K1m/K3/K4/K5/K7/K7b counters reset
   just before and every plain version made to raise on CUDA tensors (the
   user kernel's gram runs through K1d/K1m, the LOO diagonal through
   K7b).  Checks: each kernel launched; at the fitted covparam, mixed vs the card's f64
   engine: REML rel 1e-6 (bench.py's gate), gradient within the class
   envelope of BENCHMARKS.md (1e-3 log s2, 1e-4 the others; relative at
   p0, and at the optimum, where the gradient is ~0, relative to the
   larger of the trace and quadratic terms it is the difference of,
   computed in the same run), LOO within TOL_SLICE, predictions within
   twice the error that the residual of predict's refined solve implies
   (_refine_probe); the port on the CPU (mixed engine, plain versions):
   REML rel 1e-8 at p0, and bench.py's 1e-6 at the card's covparam
   (cond(K) ~3e6 there; see phase_slice).
3c. Conditional sample paths at full width: phase 3b's model and data,
   xt = xi plus 7192 uniform points (seed 8), nt = 8192; on each engine at
   p0 and at the fitted covparam: 1024 paths (Model.sample_paths),
   predict(return_lambdas=True), conditional_sample_paths, with the
   counters reset and every plain version raising.  Checks: the branch
   sample_paths took (the mixed engine at p0 must take sampling_sqrt, K5
   and K8s launched), |C C^T - K|_F / |K|_F < 1e-8, the mean of the
   conditioned paths within 5.5 standard errors (from the paths' own
   variance) of predict's mean at every point, the card against the port
   on the CPU with the same normals (f64 engine: 1e-8 at p0; printed, not
   gated, at the fit, where cond(K) is far larger); examples 10 and 11 at
   nt = 200 on both engines: conditioned paths interpolate the noise-free
   observations to 1e-6.
4. Times on the card (CUDA events / synchronised host clock): K1 and K2 vs
   their plain versions at the main path's shapes; REML value+grad evals/s
   at n = 1000 and 8192 (kernels and plain gram); fit+predict wall-clock.
4b. K3/K4/K5/K7: kernel, plain and library-call ms at the slice's shapes
   (n = 1000); the noisy model's REML value+grad evals/s at n = 1000 and
   8192 on the mixed and f64 engines in turns; fit+LOO+predict wall-clock
   (first and warm); the rise of torch.cuda.max_memory_allocated over
   what was held before at n = 8192, per engine, for one value+grad and
   for the engine alone (solve_and_logdet and its backward on a fixed K).
4c. K1d, K1m, K7b, K8s and the two products that stand in for K6:
   kernel, plain and library-call ms at the slice's shapes (n = 1000, and
   K8s at 8192), with bound and share; the full-width sample-paths call
   (nt = 8192, 1024 paths) per engine, first (phase 3c) and warm.
5. Where the time goes: torch.profiler over the noisy model's REML
   value+grad at n = 1000 and 8192, mixed and f64 engines, device time per
   evaluation by kernel group.

The line before the last is {"kernels": [...]}, with each kernel's
least time on the card (bound_ms) computed from this run's shapes against
the H100 SXM's data-sheet peaks (PEAK_*); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import gc
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

# H100 SXM data-sheet peaks (NVIDIA; dense, at the 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 34e12         # f64 on the vector units
PEAK_F64_TENSOR_FLOPS = 67e12  # f64 on the tensor cores (matrix products)
PEAK_F32_FLOPS = 67e12         # f32 outside the tensor cores

# phase 2b: kernel vs plain on the card, max|kernel - plain| / max|plain|
TOL_MIXED = {
    # f64 sums over n <= 4099 terms in another order: <= n eps64 relative
    "K3": 1e-12,
    # R = K - L L^T ~ eps32 |K|; the f64 sums in another order differ by up
    # to ~n eps64 |K| ~ 5e-13 |K|, then one f32 rounding
    "K4": 1e-5,
    # f32 forward substitution in another order than the plain version's
    # batched products: each is off by ~eps32 cond(L) <= 6e-8 * 1e3 = 6e-5
    # (cond(L) = cond(K)^(1/2) <= 1e3)
    "K5": 1e-4,
    # f64 sums of exact products of f32 values, in another order
    "K7": 1e-12,
}
MIXED_SIZES = (1000, 1024, 4099)  # 4099: a ragged last block for K5
MIXED_CONDS = (1e3, 1e6)          # the series and the two-level logdet branches
# phase 3b: mixed vs the card's f64 engine at the fitted covparam
TOL_SLICE = {
    "reml": 1e-6,  # bench.py's gate, |v_mixed - v_f64| / max(|v_f64|, 1)
    # BENCHMARKS.md class envelope per component: log s2, log noise, log 1/rho
    "grad": (1e-3, 1e-4),
    # LOO (n_refine sweeps, no early exit): at the fitted covparam cond(K)
    # ~3e6, near the f32 range; measured 1.7e-6 (zloo) on the card
    "loo": 1e-5,
}
# predictions: predict's refined solve keeps the reference's stagnation
# exit (r2 < r2_prev / 4), so at cond(K) ~3e6 it may stop with a residual
# R = B - K X well above f64 roundoff.  Predict's mean and variance are held
# to the error that this R implies to first order (_refine_probe), times
# PREDICT_SLACK for the second-order terms, plus TOL_PATH for f64 roundoff.
PREDICT_SLACK = 2.0
SLICE_N, SLICE_NT, SLICE_D, SLICE_SEED, SLICE_NOISE = 1000, 1000, 6, 7, 0.1
NOISY_EVAL_SIZES = ((1000, 20), (8192, 3))  # (n, evaluations per window)
# phase 2c: kernel vs plain on the card, max|kernel - plain| / max|plain|
TOL_2C = {
    # forward: ~3d f64 operations and a sqrt or exp per entry, in another
    # order (FMA contraction) than torch's; f32 within a few ulps
    ("K1d", "float64"): 1e-14, ("K1d", "float32"): 1e-5,
    ("K1m", "float64"): 1e-14, ("K1m", "float32"): 1e-5,
    # pullbacks: f64 sums of n^2 terms in another order (K1d); elementwise (K1m)
    ("K1d pullback", "float64"): 1e-12, ("K1d pullback", "float32"): 1e-5,
    ("K1m backward", "float64"): 1e-12, ("K1m backward", "float32"): 1e-5,
    # the kernel sums the series correction in f64 where the plain version
    # keeps the JAX package's f32 sum: held on diag(K^-1) to the LOO bar
    ("K7b", "float64"): 1e-8,
    # E = K - L L^T in f64, sums in another order: max|dE| <= 1e-12 max|K|
    ("K8s", "float64"): 1e-12,
}
DIST_SIZES, DIST_DIMS, DIST_P = (1000, 4099), (1, 6), (0, 2, 3)
K8S_SIZES = (1000, 4099, 8192)
# phase 3c: conditional sample paths at full width
PATHS_NT, PATHS_COUNT, PATHS_SEED = 8192, 1024, 8
PATHS_SE = 5.5  # conditioned mean vs predict, in standard errors
TOL_SQRT = 1e-8  # |C C^T - K|_F / |K|_F, tests/test_ops.py's bar


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

    PLAIN = {
        "gram": ("matern_gram_plain", "matern_gram_pullback_plain",
                 "maternp_kernel_plain", "maternp_kernel_backward_plain"),
        "distance": ("scaled_distance_plain", "scaled_distance_pullback_plain",
                     "scaled_distance_elementwise_plain",
                     "scaled_distance_elementwise_pullback_plain"),
        "mixed": ("residual_plain", "factorization_residual_plain",
                  "diag_block_inv_plain", "trace_sums_plain", "series_sums_plain",
                  "loo_diag_series_plain", "loo_diag_pairs_plain"),
        "refine": ("sampling_residual_plain",),
    }

    def __init__(self, *modules):
        self.modules = modules
        self.saved = []

    def __enter__(self):
        for mod in self.modules:
            for name in self.PLAIN[mod.__name__.rsplit(".", 1)[-1]]:
                orig = getattr(mod, name)
                self.saved.append((mod, name, orig))

                def guarded(*args, _orig=orig, _name=name, **kw):
                    if any(getattr(a, "is_cuda", False) for a in args):
                        raise AssertionError(f"{_name} reached with CUDA tensors")
                    return _orig(*args, **kw)

                setattr(mod, name, guarded)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


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


# ----------------------------------------------------------------------------
# the mixed engine: kernels K3/K4/K5/K7 and the noisy-regression slice
# ----------------------------------------------------------------------------
def _noisy_matern_family(torch, gram, n, conds, seed):
    """Matern p=2 gram on n uniform points in [0, 1]^6 (s2 = 1, rho = 1.5)
    plus tau I, tau set from the gram's eigenvalues so that cond(K) = cond
    (or as near as the gram allows), for each cond in conds from one
    eigendecomposition.  Returns [(K, its condition number)]."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(size=(n, 6)), device=DEVICE)
    theta = torch.tensor([0.0] + [math.log(1 / 1.5)] * 6, dtype=torch.float64,
                         device=DEVICE)
    G = gram.matern_gram_plain(x, x, 2, theta)
    G = (G + G.T) / 2
    lam = torch.linalg.eigvalsh(G)
    lo, hi = max(float(lam[0]), 0.0), float(lam[-1])
    out = []
    for cond in conds:
        tau = max((hi - cond * lo) / (cond - 1.0), hi / cond * 1e-3)
        K = G + tau * torch.eye(n, dtype=torch.float64, device=DEVICE)
        out.append((K, (hi + tau) / (float(lam[0]) + tau)))
    return out


def _noisy_matern_spd(torch, gram, n, cond, seed):
    return _noisy_matern_family(torch, gram, n, (cond,), seed)[0]


def _k7b_inputs(torch, mixed, K, M32):
    """The series (M32, B32 = (D - D^2) M32) and two-level (G, W) inputs of
    K7b for K, as mixed._inv_diag builds them, and whether the LOO block
    takes the series branch there."""
    n = K.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    M = M32.double()
    D = M @ (K @ M.T) - eye
    D32 = D.float()
    G, W, _DL = mixed._kinv_two_level(D + eye, M)
    series = float(torch.sum(D * D)) < mixed._SERIES_TAU
    return (M32.contiguous(), (D32 - D32 @ D32) @ M32), (G, W), series


def phase_mixed_kernels_vs_plain(torch, gram, mixed):
    worst, main_abs, branches = {}, {}, set()
    worst_7b = {}
    for n in MIXED_SIZES:
        for ci, cond in enumerate(MIXED_CONDS):
            K, cond_k = _noisy_matern_spd(torch, gram, n, cond, 31 * n + ci)
            gen = torch.Generator(device=DEVICE).manual_seed(n + ci)
            L32, M32 = mixed._f32_preconditioner(K)
            errs = {}
            for k in (2, 8):
                X = torch.randn(n, k, dtype=torch.float64, device=DEVICE, generator=gen)
                B = torch.randn(n, k, dtype=torch.float64, device=DEVICE, generator=gen)
                R, nr = mixed.residual_cuda(K, X, B)
                Rp, nrp = mixed.residual_plain(K, X, B)
                R2, nr2 = mixed.residual_cuda(K, X, B)
                check(torch.equal(R, R2) and torch.equal(nr, nr2), "K3 not reproducible")
                errs["K3"] = max(errs.get("K3", 0.0), rel_err(R, Rp), rel_err(nr, nrp))
                if k == 2 and n == SLICE_N and ci == 0:
                    main_abs["K3"] = float((R - Rp).abs().max())
            F = mixed.factorization_residual_cuda(K, L32)
            Fp = mixed.factorization_residual_plain(K, L32)
            check(torch.equal(F, F.T), f"K4 not symmetric at n={n}")
            errs["K4"] = rel_err(F, Fp)
            base = mixed.TRI_INV_BASE
            Bk = mixed.diag_block_inv_cuda(L32, base)
            Bp = mixed.diag_block_inv_plain(L32, base)
            check(bool((torch.triu(Bk, 1) == 0).all()), "K5 not lower triangular")
            errs["K5"] = rel_err(Bk, Bp)
            H = M32 @ (Fp @ M32.T)
            H2 = H @ H
            t, tp = mixed.trace_sums_cuda(H), mixed.trace_sums_plain(H)
            u, up = mixed.series_sums_cuda(H, H2), mixed.series_sums_plain(H, H2)
            check(torch.equal(t, mixed.trace_sums_cuda(H)), "K7 not reproducible")
            errs["K7"] = float(torch.max(torch.abs(torch.cat([t - tp, u - up]))
                                         / torch.abs(torch.cat([tp, up]))))
            # K7b (phase 2c) on the same inputs: the series sums, held where the
            # LOO block takes that branch and printed elsewhere, and the
            # two-level sums, held everywhere (f64 on both sides)
            (Ms, Bs), (G, W), series_here = _k7b_inputs(torch, mixed, K, M32)
            d_s = mixed.loo_diag_series_cuda(Ms, Bs, torch.float64)
            d_sp = mixed.loo_diag_series_plain(Ms, Bs, torch.float64)
            d_p, d_pp = mixed.loo_diag_pairs_cuda(G, W), mixed.loo_diag_pairs_plain(G, W)
            check(torch.equal(d_s, mixed.loo_diag_series_cuda(Ms, Bs, torch.float64)),
                  "K7b not reproducible")
            e7s, e7p = rel_err(d_s, d_sp), rel_err(d_p, d_pp)
            tol7 = TOL_2C[("K7b", "float64")]
            say(f"[phase 2c] K7b n={n} cond={cond_k:.2e}: series {e7s:.2e}"
                f"{'' if series_here else ' (branch not taken here, not held)'}, "
                f"two-level {e7p:.2e} (tol {tol7})")
            check(e7p <= tol7 and (e7s <= tol7 or not series_here),
                  f"K7b n={n} cond={cond:.0e}: series {e7s:.3e}, two-level {e7p:.3e}")
            for key, val in (("series", e7s if series_here else 0.0), ("two-level", e7p)):
                worst_7b[key] = max(worst_7b.get(key, 0.0), val)
            if n == SLICE_N and ci == 0:
                main_abs["K7b"] = float((d_s - d_sp).abs().max())
            if n == SLICE_N and ci == 0:
                # the float32 builds of K3/K4 (GPMP_DTYPE=float32), against the
                # plain versions in f64 on the same f32 inputs: the kernels
                # accumulate in f64, so K3 is within an f32 rounding of R and
                # K4 within K4's own tolerance
                K32 = K.float()
                X32, B32 = X.float(), B.float()
                e3 = rel_err(mixed.residual_cuda(K32, X32, B32)[0].double(),
                             mixed.residual_plain(K32.double(), X32.double(), B32.double())[0])
                e4 = rel_err(mixed.factorization_residual_cuda(K32, L32),
                             mixed.factorization_residual_plain(K32.double(), L32))
                say(f"[phase 2b] float32 K3 {e3:.2e} (tol 1e-6), K4 {e4:.2e}")
                check(e3 <= 1e-6 and e4 <= TOL_MIXED["K4"], "float32 K3/K4 vs plain")
                main_abs["K4"] = float((F - Fp).abs().max())
                main_abs["K5"] = float((Bk - Bp).abs().max())
                main_abs["K7"] = float(torch.max(torch.abs(torch.cat([t - tp, u - up]))))
            # the engine end to end on the card, against the f64 Cholesky
            z = torch.randn(n, dtype=torch.float64, device=DEVICE, generator=gen)
            x, ld = mixed.mp_solve_and_logdet(K, z)
            C = torch.linalg.cholesky(K)
            ld64 = float(2.0 * torch.sum(torch.log(torch.diagonal(C))))
            x64 = torch.cholesky_solve(z[:, None], C)[:, 0]
            branch = "series" if float(t[1]) < mixed._SERIES_TAU else "two-level"
            branches.add(branch)
            e_ld = abs(float(ld) - ld64) / abs(ld64)
            e_x = rel_err(x, x64)
            say(f"[phase 2b] n={n} cond={cond_k:.2e} ({branch}): "
                + " ".join(f"{key} {val:.2e}" for key, val in errs.items())
                + f"; engine logdet rel {e_ld:.2e}, solve rel {e_x:.2e}")
            for key, val in errs.items():
                check(val <= TOL_MIXED[key], f"{key} n={n} cond={cond:.0e}: "
                      f"{val:.3e} > {TOL_MIXED[key]}")
                worst[key] = max(worst.get(key, 0.0), val)
            check(e_ld <= 1e-6 and e_x <= 1e-4, f"engine vs f64 at n={n} cond={cond:.0e}")
    check(branches == {"series", "two-level"}, f"logdet branches run: {sorted(branches)}")
    for key, val in sorted(worst.items()):
        say(f"[phase 2b] worst {key} rel err {val:.3e} (tol {TOL_MIXED[key]})")
    say(f"[phase 2c] worst K7b rel err, where held: {worst_7b}")
    return main_abs


def _dist_inputs(torch, n, d, dtype, seed):
    """(loginvrho, x, y, dbar) on the card: x with duplicated rows (x[10:20]
    = x[:10]), y with points coincident with x (y[:5] = x[:5])."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[10:20] = x[0:10]
    y = rng.uniform(size=(n, d))
    y[:5] = x[:5]
    vals = (rng.uniform(-0.5, 1.5, size=d), x, y, rng.normal(size=(n, n)))
    return [torch.as_tensor(a, dtype=dtype, device=DEVICE) for a in vals]


def phase_new_kernels_vs_plain(torch, gram, distance, mixed, refine):
    """Phase 2c: K1d, K1m and K8s against their plain versions (K7b runs in
    phase 2b's loop, on its inputs)."""
    worst, main_abs = {}, {}

    def held(key, dname, err, tag):
        tol = TOL_2C[(key, dname)]
        check(math.isfinite(err) and err <= tol, f"{key} {tag}: {err:.3e} > {tol}")
        worst[(key, dname)] = max(worst.get((key, dname), 0.0), err)
        return err

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for n in DIST_SIZES:
            for d in DIST_DIMS:
                l, x, y, dbar = _dist_inputs(torch, n, d, dtype, 1000 + n + d)
                tag = f"{dname} n={n} d={d}"
                D = distance.scaled_distance_cuda(l, x, y)
                Dp = distance.scaled_distance_plain(l, x, y)
                g = distance.scaled_distance_pullback_cuda(dbar, l, x, y)
                gp_ = distance.scaled_distance_pullback_plain(dbar, l, x, y)
                check(torch.equal(g, distance.scaled_distance_pullback_cuda(dbar, l, x, y)),
                      "K1d pullback is not bitwise reproducible")
                db1 = dbar[:, 0].contiguous()
                De = distance.scaled_distance_elementwise_cuda(l, x, y)
                Dep = distance.scaled_distance_elementwise_plain(l, x, y)
                ge = distance.scaled_distance_elementwise_pullback_cuda(db1, l, x, y)
                gep = distance.scaled_distance_elementwise_pullback_plain(db1, l, x, y)
                torch.cuda.synchronize()
                check(bool((D.diagonal()[:5] == 0).all() and (D[10:15, :5].diagonal() == 0).all()
                           and (De[:5] == 0).all()),
                      f"K1d {tag}: coincident points do not give 0")
                errs = [held("K1d", dname, rel_err(D, Dp), tag),
                        held("K1d pullback", dname, rel_err(g, gp_), tag),
                        held("K1d", dname, rel_err(De, Dep), tag + " elementwise"),
                        held("K1d pullback", dname, rel_err(ge, gep), tag + " elementwise")]
                line = (f"[phase 2c] {tag}: K1d {errs[0]:.2e} pullback {errs[1]:.2e} "
                        f"elementwise {errs[2]:.2e}/{errs[3]:.2e}; K1m")
                if dname == "float64" and n == SLICE_N and d == SLICE_D:
                    main_abs["K1d"] = float((D - Dp).abs().max())
                    main_abs["K1d pullback"] = float((g - gp_).abs().max())
                for p in DIST_P:
                    K = gram.maternp_kernel_cuda(p, D)
                    Kp = gram.maternp_kernel_plain(p, D)
                    b = gram.maternp_kernel_backward_cuda(p, D, dbar)
                    bp = gram.maternp_kernel_backward_plain(p, D, dbar)
                    e_f = held("K1m", dname, rel_err(K, Kp), f"{tag} p={p}")
                    e_b = held("K1m backward", dname, rel_err(b, bp), f"{tag} p={p}")
                    line += f" p={p} {e_f:.2e}/{e_b:.2e}"
                    if dname == "float64" and n == SLICE_N and d == SLICE_D and p == 2:
                        main_abs["K1m"] = float((K - Kp).abs().max())
                        main_abs["K1m backward"] = float((b - bp).abs().max())
                say(line)
                del D, Dp, dbar

    for n in K8S_SIZES:
        fam = _noisy_matern_family(torch, gram, n, MIXED_CONDS, 77 + n)
        for ci, (K, cond_k) in enumerate(fam):
            L32, _M32 = mixed._f32_preconditioner(K)
            E = refine.sampling_residual_cuda(K, L32)
            Ep = refine.sampling_residual_plain(K, L32)
            check(torch.equal(E, E.T), f"K8s not symmetric at n={n}")
            err = float((E - Ep).abs().max()) / float(K.abs().max())
            say(f"[phase 2c] K8s n={n} cond={cond_k:.2e}: max|dE|/max|K| {err:.2e}")
            held("K8s", "float64", err, f"n={n} cond={cond_k:.2e}")
            if n == SLICE_N and ci == 0:
                main_abs["K8s"] = float((E - Ep).abs().max())
        del fam, K, E, Ep
    for (key, dname), val in sorted(worst.items()):
        say(f"[phase 2c] worst {key} {dname} {val:.3e} (tol {TOL_2C[(key, dname)]})")
    return main_abs


def _bench_data(n, seed=SLICE_SEED, d=SLICE_D):
    """bench.py's data and p0 (bench.py:250-287)."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(n, d))
    zi = (np.sin(3 * xi[:, 0]) + 0.5 * np.cos(5 * xi[:, 1])
          + SLICE_NOISE * rng.normal(size=n))
    p0 = np.concatenate([[np.log(np.var(zi))], [2 * np.log(0.1) + np.log(np.var(zi))],
                         -np.log(np.std(xi, axis=0))])
    return xi, zi, p0


def _bench_model(gp, gnp, covparam=None):
    """bench.py's user kernel: Matern p=2 plus a noise variance, constant mean."""
    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, param, pairwise=False):
        sigma2 = gnp.exp(param[0])
        loginvrho = param[2:]
        if y is x or y is None:
            noise_variance = gnp.exp(param[1])
            if pairwise:
                return sigma2 * gnp.ones((x.shape[0],))
            K = gnp.scaled_distance(loginvrho, x, x)
            return sigma2 * gp.kernel.maternp_kernel(2, K) + (
                noise_variance * gnp.eye(K.shape[0]))
        if pairwise:
            K = gnp.scaled_distance_elementwise(loginvrho, x, y)
        else:
            K = gnp.scaled_distance(loginvrho, x, y)
        return sigma2 * gp.kernel.maternp_kernel(2, K)

    return gp.Model(constant_mean, kernel, covparam=covparam)


def _reml_vg(gp, model, xi, zi, p):
    crit = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    return crit[1](p), crit[3](p)


def _fit_loo_predict(gp, gnp, torch, xi, zi, xt, p0):
    model = _bench_model(gp, gnp)
    t0 = time.perf_counter()
    crit, crit_pre, _crit_ng, grad = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    covparam, info = gp.kernel.autoselect_parameters(p0, crit_pre, grad, info=True)
    model.covparam = gnp.asarray(covparam)
    loo = model.loo(xi, zi)
    zpm, zpv = model.predict(xi, zi, xt)
    torch.cuda.synchronize()
    return model, info, loo, (zpm, zpv), time.perf_counter() - t0


def _refine_probe(gp, gnp, mixed, torch, covparam, xi, zi, xt, zpm64, zpv64, sweeps=5):
    """Predict's refined solve K X = B = [K_it, P] at covparam (constant
    mean: P = 1, P_t = 1), on the configured device.  Returns

    - cond(K);
    - for the engine's f32 inverse M of the f32 factor and for the library
      triangular solve's: M's relative error against the f64 inverse, and
      r2 = |R|^2 / |B|^2 after each of `sweeps` sweeps without early exit;
    - the relative errors of predict's mean and variance (against zpm64,
      zpv64 from the f64 engine) that the residual R = B - K X of the
      engine's own solve (refined_solve: early exit and all) implies, to
      first order.  With a = K^{-1} K_it, b = K^{-1} P and alpha = K^{-1} z
      exact (f64 Cholesky), the engine's X = [a + da, b + db] has
      K da = -R_a and K db = -R_b, so that per test point
        c = P'b, s = P'a - 1, mu = s / c, dmu = (mu b'R_b - b'R_a) / c,
        d mean = -alpha'R_a + mu alpha'R_b - (z'b) dmu,
        d var  = a'R_a - mu a'R_b + s dmu;
    - r2 of the engine's solve."""
    m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
    x_i, x_t, c = gnp.asarray(xi), gnp.asarray(xt), gnp.asarray(covparam)
    z = gnp.asarray(zi)
    K = m.covariance(x_i, x_i, c)
    Kit = m.covariance(x_i, x_t, c)
    nt = Kit.shape[1]
    B = torch.cat([Kit, gnp.ones((x_i.shape[0], 1))], dim=1)
    lam = torch.linalg.eigvalsh(K)
    L32, M32 = mixed._f32_preconditioner(K)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    Minv = torch.linalg.solve_triangular(L32.double(), eye, upper=False)
    out = {}
    for name, M in (("engine", M32),
                    ("trsm", torch.linalg.solve_triangular(L32, eye.float(), upper=False))):
        X, r2 = mixed._apply(M, B), []
        for _ in range(sweeps):
            R, norms = mixed.residual(K, X, B)
            r2.append(mixed._rel2(norms, K.dtype))
            X = X + mixed._apply(M, R)
        out[name] = (rel_err(M.double(), Minv), r2)

    X = mixed.refined_solve(K, B)
    R = B - K @ X
    C = torch.linalg.cholesky(K)
    X64 = torch.cholesky_solve(B, C)
    alpha = torch.cholesky_solve(z[:, None], C)[:, 0]
    a, b, Ra, Rb = X64[:, :nt], X64[:, nt], R[:, :nt], R[:, nt]
    s = a.sum(0) - 1.0
    mu = s / b.sum()
    dmu = (mu * (b @ Rb) - b @ Ra) / b.sum()
    d_mean = -(alpha @ Ra) + mu * (alpha @ Rb) - (z @ b) * dmu
    d_var = (a * Ra).sum(0) - mu * (a.T @ Rb) + s * dmu
    implied = (float(d_mean.abs().max()) / float(np.max(np.abs(zpm64))),
               float(d_var.abs().max()) / float(np.max(np.abs(zpv64))))
    r2_engine = float((R * R).sum() / (B * B).sum())
    return float(lam[-1] / lam[0]), out, implied, r2_engine


def _reml_grad_terms(gp, gnp, torch, covparam, xi, zi):
    """The two parts of the REML gradient at covparam, in plain f64 on the
    configured device (constant mean): the trace term 1/2 d(log|K| +
    log|P'K^{-1}P|), which is 1/2 tr(W dK) with W the REML projection, and
    the quadratic term 1/2 d(z'W z), which is -1/2 (Wz)' dK (Wz).  Near
    the optimum they cancel, and each gradient component is a difference of
    two numbers of this size."""
    c = gnp.asarray(covparam).clone().requires_grad_(True)
    x, z = gnp.asarray(xi), gnp.asarray(zi)
    K = _bench_model(gp, gnp).covariance(x, x, c)
    P = gnp.ones((x.shape[0], 1))
    C = torch.linalg.cholesky(K)
    X = torch.cholesky_solve(torch.cat([z[:, None], P], dim=1), C)
    Cm = torch.linalg.cholesky(P.T @ X[:, 1:])
    u = torch.linalg.solve_triangular(Cm, (P.T @ X[:, 0])[:, None], upper=False)
    ld = 2.0 * (torch.log(torch.diagonal(C)).sum() + torch.log(torch.diagonal(Cm)).sum())
    quad = z @ X[:, 0] - (u * u).sum()
    g_tr = torch.autograd.grad(0.5 * ld, c, retain_graph=True)[0]
    g_q = torch.autograd.grad(0.5 * quad, c)[0]
    return gnp.to_np(g_tr), gnp.to_np(g_q)


def _counters(gram, distance, mixed, refine):
    """name -> (module, attribute) of each launch counter."""
    return {"K1d": (distance, "K1D_LAUNCHES"), "K1d pullback": (distance, "K1D_PULLBACK_LAUNCHES"),
            "K1m": (gram, "K1M_LAUNCHES"), "K1m backward": (gram, "K1M_BACKWARD_LAUNCHES"),
            "K3": (mixed, "K3_LAUNCHES"), "K4": (mixed, "K4_LAUNCHES"),
            "K5": (mixed, "K5_LAUNCHES"), "K7": (mixed, "K7_LAUNCHES"),
            "K7b": (mixed, "K7B_LAUNCHES"), "K8s": (refine, "K8S_LAUNCHES")}


def _reset(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read(counters):
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def phase_slice(gp, gnp, gram, distance, mixed, refine, torch):
    xi, zi, p0 = _bench_data(SLICE_N)
    xt = np.random.default_rng(SLICE_SEED + 1).uniform(size=(SLICE_NT, SLICE_D))
    zt = np.sin(3 * xt[:, 0]) + 0.5 * np.cos(5 * xt[:, 1])
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("mixed")
    counters = {k: v for k, v in _counters(gram, distance, mixed, refine).items() if k != "K8s"}
    _reset(counters)
    with _PlainGuard(gram, distance, mixed, refine):
        model, info, loo, (zpm, zpv), t_first = _fit_loo_predict(
            gp, gnp, torch, xi, zi, xt, p0)
    launches = _read(counters)
    say(f"[phase 3b] slice launches {launches}; fit+LOO+predict (first) {t_first:.3f} s; "
        f"nfev {info.nfev}; REML {info.fun!r}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the slice's path")
    covparam = np.asarray(info.x)
    say(f"[phase 3b] covparam {covparam.tolist()}")
    check(np.all(np.isfinite(covparam)), "covparam not finite")
    zloo, s2loo, eloo = (gnp.to_np(a) for a in loo)
    check(all(a.shape == (SLICE_N,) and np.all(np.isfinite(a)) for a in (zloo, s2loo, eloo)),
          "LOO outputs not finite or of the wrong shape")
    check(np.all(s2loo > 0), "LOO variances not positive")
    check(zpm.shape == (SLICE_NT,) and np.all(np.isfinite(zpm)) and np.all(np.isfinite(zpv)),
          "predictions not finite or of the wrong shape")
    rmse = float(np.sqrt(np.mean((zpm - zt) ** 2)))
    loo_rmse = float(np.sqrt(np.mean(eloo ** 2)))
    say(f"[phase 3b] test RMSE {rmse:.4e} (std {float(np.std(zt)):.4e}); LOO RMSE {loo_rmse:.4e}")
    check(rmse < np.std(zt), "RMSE is not below the spread of the test values")

    # the preconditioner applications that K6 will fuse, per REML value+grad
    xi_c, zi_c = gnp.asarray(xi), gnp.asarray(zi)
    k6 = {}
    for name, p in (("p0", p0), ("fit", covparam)):
        m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
        mixed.K6_APPLIES = 0
        _reml_vg(gp, m, xi_c, zi_c, p)
        k6[name] = mixed.K6_APPLIES
    say(f"[phase 3b] K6 stand-in (two f32 torch.matmul) calls per REML value+grad: {k6}")

    # mixed vs the card's f64 engine, at the fitted covparam (and at p0)
    res = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
        res[engine] = (_reml_vg(gp, m, xi_c, zi_c, covparam), _reml_vg(gp, m, xi_c, zi_c, p0),
                       [gnp.to_np(a) for a in m.loo(xi_c, zi_c)], m.predict(xi, zi, xt))
    (vm, gm), (vm0, gm0), loo_m, pred_m = res["mixed"]
    (vf, gf), (vf0, gf0), loo_f, pred_f = res["f64"]
    env = np.array([TOL_SLICE["grad"][0]] + [TOL_SLICE["grad"][1]] * (len(covparam) - 1))
    e_v = abs(vm - vf) / max(abs(vf), 1.0)
    # near the optimum each gradient component is a difference of a trace
    # term and a quadratic term that cancel: its error is held relative to
    # the larger of the two, taken from this run (plain f64 on the card)
    g_tr, g_q = _reml_grad_terms(gp, gnp, torch, covparam, xi, zi)
    floor = np.maximum(np.abs(g_tr), np.abs(g_q))
    e_split = np.max(np.abs(g_tr + g_q - gf) / floor)
    e_g = np.abs(gm - gf) / np.maximum(np.abs(gf), floor)
    e_g0 = np.abs(gm0 - gf0) / np.abs(gf0)
    e_loo = [rel_err_np(a, b) for a, b in zip(loo_m, loo_f)]
    e_pred = [rel_err_np(a, b) for a, b in zip(pred_m, pred_f)]
    say(f"[phase 3b] REML gradient terms at the fit: trace "
        f"{np.array2string(g_tr, precision=3, max_line_width=200)}, quadratic "
        f"{np.array2string(g_q, precision=3, max_line_width=200)}; "
        f"their sum vs the f64 engine's gradient {e_split:.2e} (tol {TOL_PATH})")
    say(f"[phase 3b] mixed vs f64 on the card: REML rel {e_v:.3e}; grad at the fit "
        f"{np.array2string(e_g, precision=2)} (rel to the larger term), at p0 "
        f"{np.array2string(e_g0, precision=2)} (rel); LOO zloo/sigma2loo/eloo "
        f"{e_loo[0]:.2e}/{e_loo[1]:.2e}/{e_loo[2]:.2e}; predict mean/var "
        f"{e_pred[0]:.2e}/{e_pred[1]:.2e}")
    check(e_v <= TOL_SLICE["reml"], f"REML mixed vs f64 rel {e_v:.3e}")
    check(e_split <= TOL_PATH, f"REML gradient terms do not add up: {e_split:.3e}")
    check(np.all(e_g <= env) and np.all(e_g0 <= env), "gradient outside the class envelope")
    check(max(e_loo[:2]) <= TOL_SLICE["loo"], f"LOO mixed vs f64 {e_loo}")
    # predict: held to the error that its refined solve's residual implies
    # (on the card); the CPU's run is printed beside it
    for dev in (DEVICE, "cpu"):
        gp.config.set_device(dev)
        try:
            cond, probe, implied, r2_engine = _refine_probe(
                gp, gnp, mixed, torch, covparam, xi, zi, xt, *pred_f)
        finally:
            gp.config.set_device(DEVICE)
        for name, (e_m, r2) in probe.items():
            say(f"[phase 3b] predict's refined solve on {dev} at the fit, cond(K) {cond:.3e}: "
                f"f32 inverse from the {name}, rel err {e_m:.2e}, r2 by sweep "
                + " ".join(f"{v:.1e}" for v in r2))
        say(f"[phase 3b] on {dev}: the engine's solve leaves r2 {r2_engine:.2e}, which "
            f"implies predict mean/var errors {implied[0]:.2e}/{implied[1]:.2e}")
        if dev == DEVICE:
            tol_pred = [PREDICT_SLACK * e + TOL_PATH for e in implied]
            say(f"[phase 3b] predict mixed vs f64 over what the residual implies: mean "
                f"{e_pred[0] / implied[0]:.3f}, var {e_pred[1] / implied[1]:.3f} "
                f"(tol {PREDICT_SLACK} + {TOL_PATH} / implied)")
            check(e_pred[0] <= tol_pred[0] and e_pred[1] <= tol_pred[1],
                  f"predict mixed vs f64 {e_pred} above what the residual implies {implied}")

    # the card vs the port on the CPU (mixed engine, plain versions): at p0,
    # where cond(K) is moderate and both are exact to f64 roundoff, rel 1e-8;
    # at the fitted covparam (cond(K) ~3e6) bench.py's gate, since there the
    # card's engine is itself only ~1.6e-7 from the exact f64 value (the
    # CPU's f64 engine is printed beside it as the witness)
    gp.config.set_device("cpu")
    try:
        v_cpu = {}
        for engine in ("mixed", "f64"):
            gp.config.set_chol_engine(engine)
            m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
            v_cpu[engine] = [float(m.negative_log_restricted_likelihood(
                gnp.asarray(p), gnp.asarray(xi), gnp.asarray(zi))) for p in (covparam, p0)]
    finally:
        gp.config.set_device(DEVICE)
    (v_cpu, v_cpu0), v_cpu64 = v_cpu["mixed"], v_cpu["f64"][0]
    e_c, e_c0 = abs(vm - v_cpu) / abs(v_cpu), abs(vm0 - v_cpu0) / abs(v_cpu0)
    say(f"[phase 3b] card vs CPU (mixed): REML rel {e_c0:.3e} at p0 (tol {TOL_PATH}), "
        f"{e_c:.3e} at the card's covparam (tol {TOL_SLICE['reml']}); at the latter, "
        f"CPU mixed vs CPU f64 {abs(v_cpu - v_cpu64) / abs(v_cpu64):.3e}, "
        f"card f64 vs CPU f64 {abs(vf - v_cpu64) / abs(v_cpu64):.3e}")
    check(e_c0 <= TOL_PATH, f"REML card vs CPU at p0 rel {e_c0:.3e}")
    check(e_c <= TOL_SLICE["reml"], f"REML card vs CPU at the fit rel {e_c:.3e}")
    gp.config.set_chol_engine("auto")
    return launches, (xi, zi, xt, p0, covparam), t_first, k6


def _paths_design(xi):
    """xi plus PATHS_NT - n uniform points in [0, 1]^d (seed PATHS_SEED)."""
    extra = np.random.default_rng(PATHS_SEED).uniform(size=(PATHS_NT - xi.shape[0], xi.shape[1]))
    return np.vstack([xi, extra])


def _conditional_paths(gp, gnp, torch, covparam, xi, zi, xt):
    """The slice at covparam: PATHS_COUNT paths on xt, predict's kriging
    weights, the conditioned paths.  Returns (paths, conditioned paths,
    predict's mean, seconds of the sample_paths call)."""
    model = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zsim = model.sample_paths(xt, PATHS_COUNT)
    torch.cuda.synchronize()
    t_paths = time.perf_counter() - t0
    zpm, _zpv, lam = model.predict(xi, zi, xt, return_lambdas=True)
    zc = model.conditional_sample_paths(zsim, np.arange(xi.shape[0]), zi,
                                        np.arange(xt.shape[0]), lam, convert_out=False)
    torch.cuda.synchronize()
    return zsim, zc, zpm, t_paths


class _FixedNormals:
    """gnp.randn hands out the given normals (on the configured device)."""

    def __init__(self, gnp, eps):
        self.gnp, self.eps = gnp, eps

    def __enter__(self):
        self.orig = self.gnp.randn
        self.gnp.randn = lambda *shape, generator=None: self.eps.to(self.gnp.get_device())
        return self

    def __exit__(self, *exc):
        self.gnp.randn = self.orig


def phase_paths(gp, gnp, gram, distance, mixed, refine, torch, slice_data):
    from gpmp_tpu_torch.core import sample_paths as sp

    xi, zi, _xt, p0, fit = slice_data
    xt = _paths_design(xi)
    gp.config.set_device(DEVICE)
    counters = {k: v for k, v in _counters(gram, distance, mixed, refine).items()
                if k in ("K1d", "K1d pullback", "K1m", "K1m backward", "K5", "K8s")}
    x_c = gnp.asarray(xt)
    launches_p0, t_first, card = None, {}, {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        for name, cp in (("p0", p0), ("fit", fit)):
            _reset(counters)
            before = dict(sp.BRANCHES)
            gnp.set_seed(PATHS_SEED)
            with _PlainGuard(gram, distance, mixed, refine):
                zsim, zc, zpm, t_paths = _conditional_paths(gp, gnp, torch, cp, xi, zi, xt)
            launches = _read(counters)
            branch = "+".join(k for k, v in sp.BRANCHES.items() if v != before[k])
            tag = f"{engine} at {name}"
            check(tuple(zsim.shape) == (PATHS_NT, PATHS_COUNT) and zsim.is_cuda,
                  f"paths {tag}: shape {tuple(zsim.shape)}")
            check(bool(torch.isfinite(zc).all()), f"conditioned paths {tag} not finite")
            check(launches["K1d"] > 0 and launches["K1m"] > 0,
                  f"the gram of {tag} did not go through K1d/K1m: {launches}")
            # the factor the path used, and how well it reproduces K
            K = _bench_model(gp, gnp).covariance(x_c, x_c, gnp.asarray(cp))
            C = sp.sampling_factor(K)
            e_sqrt = float(torch.linalg.norm(C @ C.T - K) / torch.linalg.norm(K))
            del C
            # the conditioned mean against predict, in standard errors
            zpm_t = torch.as_tensor(zpm, device=DEVICE)
            se = zc.std(dim=1) / math.sqrt(PATHS_COUNT)
            dev = (zc.mean(dim=1) - zpm_t).abs()
            z = float((dev / se.clamp_min(1e-300)).max())
            say(f"[phase 3c] {tag}: branch {branch}; launches {launches}; "
                f"sample_paths {t_paths:.3f} s (first); |CC'-K|/|K| {e_sqrt:.2e} "
                f"(tol {TOL_SQRT}); conditioned mean vs predict, max {z:.2f} standard errors "
                f"(tol {PATHS_SE})")
            check(e_sqrt < TOL_SQRT, f"|CC'-K|/|K| {e_sqrt:.3e} {tag}")
            check(z <= PATHS_SE, f"conditioned mean {z:.2f} standard errors from predict, {tag}")
            if (engine, name) == ("mixed", "p0"):
                check(branch == "sampling_sqrt",
                      f"the mixed engine at p0 took {branch!r}, not sampling_sqrt")
                check(launches["K5"] > 0 and launches["K8s"] > 0,
                      f"K5/K8s not launched on the mixed engine at p0: {launches}")
                launches_p0 = launches
            if name == "p0":
                t_first[engine] = t_paths
            if engine == "f64":
                lam = torch.linalg.eigvalsh(K)
                card[name] = (zsim, zc, float(lam[-1] / lam[0]))
            del K, zsim, zc

    # the card against the port on the CPU, f64 engine, the same normals
    gp.config.set_chol_engine("f64")
    for name, cp in (("p0", p0), ("fit", fit)):
        gnp.set_seed(PATHS_SEED)
        eps = gnp.randn(PATHS_NT, PATHS_COUNT).cpu()  # the normals the card drew
        gp.config.set_device("cpu")
        try:
            with _FixedNormals(gnp, eps):
                zsim_h, zc_h, _zpm, _t = _conditional_paths(gp, gnp, torch, cp, xi, zi, xt)
        finally:
            gp.config.set_device(DEVICE)
        zsim, zc, cond = card[name]
        e_p, e_c = rel_err(zsim.cpu(), zsim_h), rel_err(zc.cpu(), zc_h)
        say(f"[phase 3c] card vs CPU, f64 engine at {name} (cond(K) {cond:.3e}): paths rel "
            f"{e_p:.2e}, conditioned paths rel {e_c:.2e}"
            + (f" (tol {TOL_PATH})" if name == "p0" else " (not held at the fit)"))
        if name == "p0":
            check(e_p <= TOL_PATH and e_c <= TOL_PATH, f"paths card vs CPU at p0: {e_p}, {e_c}")
    del card

    _example_flows(gp, gnp, torch, sp)
    gp.config.set_chol_engine("auto")
    return launches_p0, t_first, xt


def _example11_kernel(gp, gnp):
    """examples/gpmp_tpu_example11's kernel through the port: the per-point
    noise variance travels as the last input column and is added on the
    same-set diagonal."""
    def kernel(x, y, covparam, pairwise=False):
        sigma2, loginvrho = gnp.exp(covparam[0]), covparam[1:]
        if y is x or y is None:
            xc, nv = x[:, :-1], x[:, -1].reshape(-1)
            if pairwise:
                return sigma2 * gnp.ones((xc.shape[0],)) + nv
            D = gnp.scaled_distance(loginvrho, xc, xc)
            return sigma2 * gp.kernel.maternp_kernel(2, D) + gnp.diag(nv)
        xc, yc = x[:, :-1], y[:, :-1]
        D = (gnp.scaled_distance_elementwise(loginvrho, xc, yc) if pairwise
             else gnp.scaled_distance(loginvrho, xc, yc))
        return sigma2 * gp.kernel.maternp_kernel(2, D)

    return kernel


def _example_flows(gp, gnp, torch, sp):
    """Examples 10 and 11 through the port on the card (nt = 200, 5
    observations, 6 paths), on both engines: prior paths, kriging weights,
    conditioned paths, which interpolate the noise-free observations."""
    xt = np.linspace(-1, 1, 200).reshape(-1, 1)
    zt = gp.misc.testfunctions.twobumps(xt)
    ind = [10, 45, 100, 130, 155]
    covparam = np.array([math.log(0.5**2), math.log(1 / 0.7)])
    noise_var = np.array([0.0, 0.02, 0.005, 0.0, 0.01])
    z11 = zt[ind].reshape(-1) + np.sqrt(noise_var) * np.random.default_rng(0).normal(size=5)

    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def builtin(x, y, c, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 2, c, pairwise)

    flows = {
        10: (gp.Model(constant_mean, builtin, None, covparam), xt, xt[ind],
             zt[ind].reshape(-1), [0, 1, 2, 3, 4]),
        11: (gp.Model(constant_mean, _example11_kernel(gp, gnp), None, covparam),
             np.hstack([xt, np.zeros((200, 1))]),
             np.hstack([xt[ind], noise_var[:, None]]), z11, [0, 3]),
    }
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        for ex, (model, xt_f, xi_f, zi, exact) in flows.items():
            before = dict(sp.BRANCHES)
            gnp.set_seed(0)
            ztsim = model.sample_paths(xt_f, 6)
            _zpm, _zpv, lam = model.predict(xi_f, zi, xt_f, return_lambdas=True)
            ztsimc = model.conditional_sample_paths(ztsim, np.asarray(ind), zi,
                                                    np.arange(200), lam)
            branch = "+".join(k for k, v in sp.BRANCHES.items() if v != before[k])
            err = float(np.max(np.abs(ztsimc[np.asarray(ind)[exact]] - zi[exact][:, None])))
            say(f"[phase 3c] example {ex} on {engine} (nt = 200): branch {branch}; "
                f"conditioned paths at the noise-free observations {err:.2e} (tol 1e-6)")
            check(ztsimc.shape == (200, 6) and np.all(np.isfinite(ztsimc)),
                  f"example {ex} on {engine}: conditioned paths")
            check(err <= 1e-6, f"example {ex} on {engine}: interpolation error {err:.3e}")


def rel_err_np(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _kernel_bounds(n, k=2, base=128, d=6, p=2):
    """(bound_ms, bound_by) of each kernel at these shapes: the larger of
    bytes (each input read once, each output written once) over the memory
    rate and operations over the peak rate for their type."""
    def bound(nbytes, flops, peak):
        t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / peak
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")

    nb = -(-n // base)
    sizes = [base] * (nb - 1) + [n - base * (nb - 1)]
    fma_k4 = sum((n - j) * (j + 1) for j in range(n))
    tri = n * (n + 1) // 2  # the lower triangle: K4 and K5 read no more of K and L
    # K4 reads K (f64) and L (f32) over the lower triangle and writes the
    # full f32 R; K5 reads the lower triangles of L's diagonal blocks and
    # writes nb base x base f32 inverses
    fp64 = PEAK_F64_FLOPS
    return {
        # gram: ~3d (distance) + 2(p+1) (Horner) + 4 (sqrt, exp, scalings) per entry
        "K1": bound(8 * (n * n + 2 * n * d + d + 1), n * n * (3 * d + 2 * (p + 1) + 4),
                    PEAK_F64_FLOPS),
        # distance: reads x, y, l, writes D; ~3d + 1 (sqrt) per entry
        "K1d": bound(8 * (n * n + 2 * n * d + d), n * n * (3 * d + 1), fp64),
        # its pullback: reads Dbar, x, y, l, writes d values; the distance,
        # a division and ~3d for the terms
        "K1d pullback": bound(8 * (n * n + 2 * n * d + 2 * d), n * n * (6 * d + 2), fp64),
        # Matern polynomial: reads D, writes K; Horner 2p, exp, 3 products
        "K1m": bound(16 * n * n, n * n * (2 * p + 4), fp64),
        # its backward: reads D and Kbar, writes Dbar
        "K1m backward": bound(24 * n * n, n * n * (2 * p + 5), fp64),
        # LOO diagonal, series branch: reads M32 and B32 (f32), writes n f64;
        # a square, a product, a difference and a sum per entry
        "K7b": bound(8 * n * n + 8 * n, 4 * n * n, fp64),
        # sampling residual: K4's work with an f64 output
        "K8s": bound(8 * tri + 4 * tri + 8 * n * n, 2 * fma_k4 + tri, PEAK_F64_TENSOR_FLOPS),
        # M^T (M r): the lower triangle of M32 read once, r (f64, k columns)
        # read and the result written; two triangular products in f32
        "K6": bound(4 * tri + 16 * n * k, 4 * tri * k, PEAK_F32_FLOPS),
        # pullback: K1's work plus ~2d + 2(p+1) + 4 for the derivative terms
        "K2": bound(8 * (n * n + 2 * n * d + d + 1 + d + 1),
                    n * n * (5 * d + 4 * (p + 1) + 8), PEAK_F64_FLOPS),
        "K3": bound(8 * (n * n + 3 * n * k) + 16, 2 * n * n * k + 4 * n * k,
                    PEAK_F64_FLOPS),
        "K4": bound(8 * tri + 4 * tri + 4 * n * n, 2 * fma_k4 + tri, PEAK_F64_TENSOR_FLOPS),
        "K5": bound(4 * sum(b * (b + 1) // 2 for b in sizes) + 4 * nb * base * base,
                    sum(b ** 3 // 3 + b * b for b in sizes), PEAK_F32_FLOPS),
        "K7": bound(8 * n * n + 32, 6 * n * n + n, PEAK_F64_FLOPS),
    }


def _device_ms(torch, fn, reps):
    """Device time per call of everything fn launches, from torch.profiler:
    the kernels' own time, without the host's launch gaps that CUDA events
    around a loop of short launches also count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if "cuda" in str(getattr(evt, "device_type", "")).lower():
            t_us = getattr(evt, "self_device_time_total", None)
            total_us += t_us if t_us is not None else getattr(evt, "self_cuda_time_total", 0.0)
    return total_us / 1e3 / reps


def _noisy_evals_per_s(gp, gnp, torch, n, reps):
    xi, zi, p0 = _bench_data(n)
    model = _bench_model(gp, gnp)
    crit, _, _, _ = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    crit(p0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        if not math.isfinite(crit(p0 + 1e-3 * i)):
            fail(f"noisy REML not finite at n={n} on {gp.config.get_chol_engine()}")
    return reps / (time.perf_counter() - t0)


def phase_mixed_times(gp, gnp, gram, mixed, torch, slice_data):
    n = SLICE_N
    K, _ = _noisy_matern_spd(torch, gram, n, 1e3, 7)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    X = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    B = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    L32, M32 = mixed._f32_preconditioner(K)
    L64 = L32.double()
    base = mixed.TRI_INV_BASE
    blocks = mixed._diag_blocks(L32, base)
    eye_b = torch.eye(base, device=DEVICE).expand(blocks.shape).contiguous()
    H = M32 @ (mixed.factorization_residual_plain(K, L32) @ M32.T)
    H2 = H @ H
    times = {
        "K3": (_time_cuda(torch, lambda: mixed.residual_cuda(K, X, B), 200),
               _time_cuda(torch, lambda: mixed.residual_plain(K, X, B), 50),
               _time_cuda(torch, lambda: torch.addmm(B, K, X, alpha=-1), 200)),
        "K4": (_time_cuda(torch, lambda: mixed.factorization_residual_cuda(K, L32), 50),
               _time_cuda(torch, lambda: mixed.factorization_residual_plain(K, L32), 50),
               _time_cuda(torch, lambda: torch.addmm(K, L64, L64.T, alpha=-1), 50)),
        "K5": (_time_cuda(torch, lambda: mixed.diag_block_inv_cuda(L32, base), 50),
               _time_cuda(torch, lambda: mixed.diag_block_inv_plain(L32, base), 5),
               _time_cuda(torch, lambda: torch.linalg.solve_triangular(
                   blocks, eye_b, upper=False), 50)),
        "K7": (_time_cuda(torch, lambda: (mixed.trace_sums_cuda(H),
                                          mixed.series_sums_cuda(H, H2)), 200),
               _time_cuda(torch, lambda: (mixed.trace_sums_plain(H),
                                          mixed.series_sums_plain(H, H2)), 50),
               None),
    }
    for key, (t_k, t_p, t_l) in times.items():
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        say(f"[phase 4b] {key} n={n}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library {lib}")

    rates = {}
    for n_e, reps in NOISY_EVAL_SIZES:
        for engine in ("mixed", "f64", "f64", "mixed"):
            gp.config.set_chol_engine(engine)
            rates.setdefault((n_e, engine), []).append(
                _noisy_evals_per_s(gp, gnp, torch, n_e, reps))
        say(f"[phase 4b] noisy REML value+grad n={n_e} d=6 f64 data: "
            + ", ".join(f"{e} {rates[(n_e, e)]}" for e in ("mixed", "f64")) + " evals/s")

    # peak memory above what was held before: one REML value+grad, and the
    # engine alone (solve_and_logdet and its backward on a fixed K)
    from gpmp_tpu_torch.core import linalg

    def peak(fn):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before

    def engine_alone():
        x, ld = linalg.solve_and_logdet(K8, rhs8)
        torch.autograd.grad(ld + x.sum(), K8)

    n8 = NOISY_EVAL_SIZES[-1][0]
    xi, zi, p0 = _bench_data(n8)
    x8 = gnp.asarray(xi)
    K8 = _bench_model(gp, gnp).covariance(x8, x8, gnp.asarray(p0)).requires_grad_(True)
    rhs8 = torch.cat([gnp.asarray(zi)[:, None], gnp.ones((n8, 1))], dim=1)
    mem = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        model = _bench_model(gp, gnp)
        mem[engine] = peak(lambda: _reml_vg(gp, model, xi, zi, p0))
        mem[f"{engine} engine alone"] = peak(engine_alone)
    del K8, rhs8
    say(f"[phase 4b] max_memory_allocated above what was held before, n={n8}: "
        + ", ".join(f"{e} {v / 2**30:.3f} GiB" for e, v in mem.items()))

    gp.config.set_chol_engine("mixed")
    xi, zi, xt, p0, _fit = slice_data
    _, info, _, _, t_warm = _fit_loo_predict(gp, gnp, torch, xi, zi, xt, p0)
    say(f"[phase 4b] fit+LOO+predict n={SLICE_N} nt={SLICE_NT} mixed (warm) {t_warm:.3f} s, "
        f"nfev {info.nfev}")
    gp.config.set_chol_engine("auto")
    return times, rates, mem, t_warm


def _time_sqrt_inputs(torch, gram, n):
    """A noisy Matern K at n (no eigendecomposition: the kernels' times do
    not depend on cond(K))."""
    x = torch.as_tensor(np.random.default_rng(n).uniform(size=(n, 6)), device=DEVICE)
    theta = torch.tensor([0.0] + [math.log(1 / 1.5)] * 6, dtype=torch.float64, device=DEVICE)
    K = gram.matern_gram_cuda(x, x, 2, theta, True)
    K.diagonal().add_(1e-2)
    return K


def phase_new_times(gp, gnp, gram, distance, mixed, refine, torch, xt_paths, slice_data,
                    t_paths_first):
    """Phase 4c: (kernel, plain, library) ms of K1d, K1m, K7b, K8s and of the
    two products that stand in for K6; the full-width sample-paths call."""
    n = SLICE_N
    l, x, _y, dbar = _dist_inputs(torch, n, SLICE_D, torch.float64, 7)
    db = (dbar + dbar.T) / 2
    D = distance.scaled_distance_cuda(l, x, x)
    xs = torch.exp(l) * x
    K = _time_sqrt_inputs(torch, gram, n)
    L32, M32 = mixed._f32_preconditioner(K)
    L64 = L32.double()
    (Ms, Bs), (G, W), _series = _k7b_inputs(torch, mixed, K, M32)
    R = torch.randn(n, 2, dtype=torch.float64, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(4))
    K8 = _time_sqrt_inputs(torch, gram, PATHS_NT)
    L8, _M8 = mixed._f32_preconditioner(K8)
    L8_64 = L8.double()
    t = lambda fn, reps: _time_cuda(torch, fn, reps)  # noqa: E731
    theta = torch.cat([torch.zeros(1, dtype=torch.float64, device=DEVICE), l])
    device = {
        "K1": _device_ms(torch, lambda: gram.matern_gram_cuda(x, x, 2, theta, True), 50),
        "K1d": _device_ms(torch, lambda: distance.scaled_distance_cuda(l, x, x), 50),
        "K1d pullback": _device_ms(
            torch, lambda: distance.scaled_distance_pullback_cuda(db, l, x, x), 50),
        "K1m": _device_ms(torch, lambda: gram.maternp_kernel_cuda(2, D), 50),
        "K1m backward": _device_ms(torch, lambda: gram.maternp_kernel_backward_cuda(2, D, db), 50),
        "K7b": _device_ms(torch, lambda: mixed.loo_diag_series_cuda(Ms, Bs, torch.float64), 50),
        "K7b two-level": _device_ms(torch, lambda: mixed.loo_diag_pairs_cuda(G, W), 50),
        "K8s": _device_ms(torch, lambda: refine.sampling_residual_cuda(K, L32), 50),
        "K8s n=8192": _device_ms(torch, lambda: refine.sampling_residual_cuda(K8, L8), 5),
        "K6": _device_ms(torch, lambda: mixed._apply(M32, R), 50),
    }
    say("[phase 4c] device time per call (torch.profiler, all kernels the call launches), "
        "ms: " + ", ".join(f"{k} {v:.4f}" for k, v in device.items()))
    times = {
        "K1d": (t(lambda: distance.scaled_distance_cuda(l, x, x), 200),
                t(lambda: distance.scaled_distance_plain(l, x, x), 50),
                t(lambda: torch.cdist(xs, xs), 200)),
        "K1d pullback": (t(lambda: distance.scaled_distance_pullback_cuda(db, l, x, x), 200),
                         t(lambda: distance.scaled_distance_pullback_plain(db, l, x, x), 20),
                         None),
        "K1m": (t(lambda: gram.maternp_kernel_cuda(2, D), 200),
                t(lambda: gram.maternp_kernel_plain(2, D), 50), None),
        "K1m backward": (t(lambda: gram.maternp_kernel_backward_cuda(2, D, db), 200),
                         t(lambda: gram.maternp_kernel_backward_plain(2, D, db), 50), None),
        "K7b": (t(lambda: mixed.loo_diag_series_cuda(Ms, Bs, torch.float64), 200),
                t(lambda: mixed.loo_diag_series_plain(Ms, Bs, torch.float64), 50), None),
        "K7b two-level": (t(lambda: mixed.loo_diag_pairs_cuda(G, W), 200),
                          t(lambda: mixed.loo_diag_pairs_plain(G, W), 50), None),
        "K8s": (t(lambda: refine.sampling_residual_cuda(K, L32), 50),
                t(lambda: refine.sampling_residual_plain(K, L32), 50),
                t(lambda: torch.addmm(K, L64, L64.T, alpha=-1), 50)),
        "K8s n=8192": (t(lambda: refine.sampling_residual_cuda(K8, L8), 5),
                       t(lambda: refine.sampling_residual_plain(K8, L8), 5),
                       t(lambda: torch.addmm(K8, L8_64, L8_64.T, alpha=-1), 5)),
        # no kernel yet: the two torch.matmul of mixed._apply are the "plain" time
        "K6": (None, t(lambda: mixed._apply(M32, R), 200), None),
    }
    del K8, L8, L8_64
    bounds = _kernel_bounds(n)
    bounds["K7b two-level"] = (max(16 * n * n / PEAK_BYTES_PER_S,
                                   2 * n * n / PEAK_F64_FLOPS) * 1e3, "bytes")
    bounds["K8s n=8192"] = _kernel_bounds(PATHS_NT)["K8s"]
    for key, (t_k, t_p, t_l) in times.items():
        b_ms, b_by = bounds[key]
        kern = "none" if t_k is None else f"{t_k:.4f} ms (device {device[key]:.4f} ms)"
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        share = "" if t_k is None else f", share {100 * b_ms / t_k:.1f}%"
        say(f"[phase 4c] {key} (n={n if 'n=' not in key else PATHS_NT}): kernel {kern}, "
            f"plain {t_p:.4f} ms, library {lib}, bound {b_ms * 1e3:.2f} us ({b_by}){share}")

    xi, zi, _xt, p0, _fit = slice_data
    t_warm = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        model = _bench_model(gp, gnp, covparam=gnp.asarray(p0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample_paths(xt_paths, PATHS_COUNT)
        torch.cuda.synchronize()
        t_warm[engine] = time.perf_counter() - t0
        say(f"[phase 4c] sample_paths nt={PATHS_NT} x {PATHS_COUNT} paths at p0 on {engine}: "
            f"first {t_paths_first[engine]:.3f} s, warm {t_warm[engine]:.3f} s")
    gp.config.set_chol_engine("auto")
    return times, bounds, t_warm, device


_GROUPS = (  # the first group whose key is in a kernel's name takes it
    ("K1m Matern elementwise", ("maternp_elem",)),
    ("K1d scaled distance", ("distance",)),
    ("K1/K2 gram", ("matern",)),
    ("K7b LOO diagonal", ("loo_diag",)),
    ("K4 factorization residual", ("fact_residual",)),
    ("K3 residual", ("residual_kernel",)),
    ("K5 diag-block inverse", ("diag_block_inv",)),
    ("K7 trace sums", ("trace_sums", "series_sums")),
    ("K3/K7 partial reduction", ("reduce_pairs",)),
    ("Cholesky (cuSOLVER potrf: getrf_wo_pivot)", ("potrf", "getrf", "cholesky")),
    ("triangular solves (trsm)", ("trsm", "trsv")),
    ("matrix products (gemm)", ("gemm", "gemv", "xmma", "cutlass", "dot_kernel",
                                "splitkreduce")),
)


PROFILE_SIZES = ((1000, 10), (8192, 3))  # (n, profiled evaluations)


def phase_profile(gp, gnp, torch):
    from torch.profiler import ProfilerActivity, profile

    summary = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=DEVICE).sum().item()  # the profiler's own start-up
    for n, reps in PROFILE_SIZES:
        summary.update(_profile_engines(gp, gnp, torch, n, reps, profile, ProfilerActivity))
    gp.config.set_chol_engine("auto")
    return summary


def _profile_engines(gp, gnp, torch, n, reps, profile, ProfilerActivity):
    xi, zi, p0 = _bench_data(n)
    summary = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        model = _bench_model(gp, gnp)
        crit = gp.kernel.make_selection_criterion_with_gradient(
            model, gp.kernel.negative_log_restricted_likelihood, xi, zi)[0]
        for i in range(3):
            crit(p0 + 1e-3 * i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                crit(p0 + 1e-3 * i)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        per_kernel = {}
        for evt in prof.key_averages():
            if "cuda" not in str(getattr(evt, "device_type", "")).lower():
                continue
            t_us = getattr(evt, "self_device_time_total", None)
            if t_us is None:
                t_us = getattr(evt, "self_cuda_time_total", 0.0)
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + t_us / 1e3 / reps
        device_ms = sum(per_kernel.values())
        groups = {}
        for name, ms in per_kernel.items():
            low = name.lower()
            label = next((g for g, keys in _GROUPS if any(k in low for k in keys)),
                         "elementwise, copies, other")
            groups[label] = groups.get(label, 0.0) + ms
        say(f"[phase 5] {engine} n={n}: wall per eval (profiled) {wall_ms:.3f} ms, "
            f"device {device_ms:.3f} ms, busy {100 * device_ms / wall_ms:.1f}%")
        for label, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            say(f"[phase 5]   {label}: {ms:.4f} ms ({100 * ms / device_ms:.1f}%)")
        for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
            say(f"[phase 5]     {ms:.4f} ms  {name[:90]}")
        if device_ms <= 0:
            say(f"[phase 5] the profiler saw no device time on {engine}: not measured")
        summary[f"n={n} {engine}"] = {"wall_ms": wall_ms, "device_ms": device_ms}
    return summary


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
        from gpmp_tpu_torch.ops import distance, gram, mixed, refine
    except ImportError as exc:
        fail(f"cannot import gpmp_tpu_torch next to this script: {exc}")
    check("jax" not in sys.modules, "jax was imported")

    t_start = time.perf_counter()
    card = phase_device_and_build(torch, build)
    main_abs = phase_kernels_vs_plain(torch, gram)
    main_abs.update(phase_mixed_kernels_vs_plain(torch, gram, mixed))
    main_abs.update(phase_new_kernels_vs_plain(torch, gram, distance, mixed, refine))
    launches, main_data, t_first = phase_main_path(gp, gnp, gram, torch)
    slice_launches, slice_data, t_slice_first, k6 = phase_slice(
        gp, gnp, gram, distance, mixed, refine, torch)
    launches.update(slice_launches)
    paths_launches, t_paths_first, xt_paths = phase_paths(
        gp, gnp, gram, distance, mixed, refine, torch, slice_data)
    launches["K8s"] = paths_launches["K8s"]
    times, rates, t_warm = phase_times(gp, gnp, gram, torch, main_data)
    mtimes, mrates, mem, t_slice_warm = phase_mixed_times(gp, gnp, gram, mixed, torch,
                                                          slice_data)
    ntimes, bounds, t_paths_warm, device_ms = phase_new_times(gp, gnp, gram, distance, mixed, refine,
                                                   torch, xt_paths, slice_data, t_paths_first)
    library = {k: v[2] for k, v in (*mtimes.items(), *ntimes.items())}
    times.update({k: v[:2] for k, v in (*mtimes.items(), *ntimes.items())})
    profile = phase_profile(gp, gnp, torch)
    check("jax" not in sys.modules, "jax was imported")

    say(json.dumps({
        "card": card,
        "fit_predict_s": {"first": t_first, "warm": t_warm},
        "reml_value_grad_evals_per_s": {f"n={n} {k}": v for (n, k), v in rates.items()},
        "noisy_fit_loo_predict_s": {"mixed first": t_slice_first, "mixed warm": t_slice_warm},
        "noisy_reml_value_grad_evals_per_s": {f"n={n} {e}": v for (n, e), v in mrates.items()},
        "max_memory_allocated_bytes_n8192": mem,
        "k6_applies_per_reml_value_grad": k6,
        "device_ms_per_call_n1000": device_ms,
        "sample_paths_nt8192_1024_s": {f"{e} {w}": v for w, d in (("first", t_paths_first),
                                                                  ("warm", t_paths_warm))
                                       for e, v in d.items()},
        "profile_ms_per_eval": {e: {"wall": v["wall_ms"], "device": v["device_ms"]}
                                for e, v in profile.items()},
        "total_s": time.perf_counter() - t_start,
    }))
    gram_src, mixed_src = "gpmp_tpu_torch/csrc/matern_gram.cu", "gpmp_tpu_torch/csrc/mixed.cu"
    dist_src = "gpmp_tpu_torch/csrc/distance.cu"
    rows = [
        ("K1", "matern_gram", gram_src, "gpmp_tpu/kernel/matern.py:69"),
        ("K2", "matern_gram_pullback", gram_src, "gpmp_tpu/parallel/likelihood.py:225"),
        ("K3", "residual", mixed_src, "gpmp_tpu/ops/mixed.py:173"),
        ("K4", "factorization_residual", mixed_src, "gpmp_tpu/ops/mixed.py:191"),
        ("K5", "diag_block_inv", mixed_src, "gpmp_tpu/ops/mixed.py:94"),
        ("K7", "trace_sums+series_sums", mixed_src, "gpmp_tpu/ops/mixed.py:378"),
        ("K7b", "loo_diag_series", mixed_src, "gpmp_tpu/ops/mixed.py:637"),
        ("K1d", "scaled_distance", dist_src, "gpmp_tpu/num/__init__.py:428"),
        ("K1d pullback", "scaled_distance_pullback", dist_src, "gpmp_tpu/num/__init__.py:389"),
        ("K1m", "maternp_kernel", gram_src, "gpmp_tpu/kernel/matern.py:49"),
        ("K1m backward", "maternp_kernel_backward", gram_src, "gpmp_tpu/kernel/matern.py:49"),
        ("K8s", "sampling_residual", mixed_src, "gpmp_tpu/ops/refine.py:114"),
    ]
    say(json.dumps({"kernels": [
        {"name": f"{key} {name}", "route": "cuda", "source": src, "replaces": where,
         "launches": launches[key], "max_abs_err": main_abs[key], "ms": times[key][0],
         "plain_ms": times[key][1], "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
         "library_ms": library.get(key)}
        for key, name, src, where in rows
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
