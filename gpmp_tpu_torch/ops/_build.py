# gpmp_tpu_torch/ops/_build.py
"""Build the CUDA sources under gpmp_tpu_torch/csrc at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles each ``csrc/*.cu`` to an object, one nvcc per source,
all started together, and ``nvcc -shared`` links them into one library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds).  The library goes to ``build/gpmp_tpu_torch/``
at the repository root, in a directory named after a hash of the sources
and flags, so an edited source is rebuilt.  nvcc's ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside it in
``ptxas.log``.

Nothing here runs at import: ``load()`` builds (once per process) when a
kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "gpmp_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall-clock of this process's build, None if not built here
source_seconds = {}   # source name -> seconds from the build's start to its nvcc's end


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the CUDA kernels")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_nvcc(args):
    return subprocess.Popen([_nvcc(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _compile(out_dir: Path) -> Path:
    lib_path = out_dir / "libgpmp_tpu_torch.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    # build into temporary names, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    objs = [tmp_dir / (src.stem + ".o") for src in cu]
    # one nvcc per source, all started together
    procs = [_run_nvcc([*NVCC_FLAGS, "-c", f"-I{_CSRC}",
                        "-o", str(obj), str(src)])
             for src, obj in zip(cu, objs)]
    logs = [""] * len(procs)

    def drain(i):  # each source's output, and when its nvcc ended
        logs[i] = procs[i].communicate()[0]
        source_seconds[cu[i].name] = time.perf_counter() - t0

    drains = [threading.Thread(target=drain, args=(i,)) for i in range(len(procs))]
    for th in drains:
        th.start()
    for th in drains:
        th.join()
    failed = [(src.name, p.returncode) for src, p in zip(cu, procs) if p.returncode]
    if not failed:
        link = _run_nvcc([*LINK_FLAGS, "-o", str(tmp_dir / lib_path.name),
                          *map(str, objs)])
        logs.append(link.communicate()[0])
        if link.returncode:
            failed.append(("link", link.returncode))
    global build_seconds
    build_seconds = time.perf_counter() - t0
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    if failed:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError(f"nvcc failed {failed}:\n" + "\n".join(logs))
    os.replace(tmp_dir / lib_path.name, lib_path)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib_path


def _declare(lib):
    vp, ll, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    signatures = {
        # ops/gram.py: K1's and K2's geometry, K1p's and K2p's
        "gpmp_matern_geometry": ([i32], i32),
        "gpmp_matern_population_geometry": ([i32], i32),
        # ops/mixed.py: K6's geometry
        "gpmp_precond_geometry": ([i32], i32),
        # ops/mixed.py: K3
        "gpmp_residual_geometry": ([i32], i32),
        # ops/refine.py: K8r, K8t; ops/chol.py: K9m
        "gpmp_refine_residual": ([vp, vp, vp, vp, ll, ll, vp, vp, vp, vp], i32),
        "gpmp_tri_product_geometry": ([i32], i32),
        "gpmp_tri_product": ([vp, vp, vp, vp, ll, ll, f64, f64, i32, vp], i32),
        "gpmp_murray": ([vp, ll, i32, vp], i32),
        # ops/chol.py: K9m's slab form (the row-sharded factor)
        "gpmp_murray_slab": ([vp, vp, ll, ll, ll, i32, vp], i32),
        # ops/chol.py: K9u and K9s (f64) on the f64 tensor cores (csrc/syrk.cu),
        # K9s (f32) on the CUDA cores (csrc/syrk_f32.cu)
        "gpmp_syrk_tile": ([], i32),
        "gpmp_syrk_mma_k": ([], i32),
        "gpmp_trailing_update": ([vp, vp, ll, ll, ll, ll, vp], i32),
        "gpmp_syrk_probe": ([vp, vp, ll, ll, ll, ll, i32, vp], i32),
        "gpmp_slab_update_f64": ([vp, vp, vp, ll, ll, ll, ll, ll, ll, vp], i32),
        "gpmp_syrk_f32_tile": ([], i32),
        "gpmp_slab_update_f32": ([vp, vp, vp, ll, ll, ll, ll, ll, ll, vp], i32),
        # ops/mixed.py: K4 and K4s, ops/refine.py: K8s, ops/streamed.py:
        # K10r, on the f64 tensor cores (csrc/residual.cu)
        "gpmp_residual_tile": ([], i32),
        "gpmp_fact_residual_mma_f64": ([vp, vp, vp, vp, ll, ll, vp], i32),
        "gpmp_fact_residual_mma_f32": ([vp, vp, vp, vp, ll, ll, vp], i32),
        "gpmp_sampling_residual_mma_f64": ([vp, vp, vp, vp, ll, ll, vp], i32),
        "gpmp_slab_fact_residual_mma": ([vp, vp, vp, vp, vp, ll, ll, ll, ll, ll, ll, vp], i32),
        "gpmp_streamed_residual_ff": ([vp, vp, vp, vp, vp, ll, ll, vp], i32),
        "gpmp_streamed_residual_panel": ([vp, vp, vp, vp, ll, ll, ll, ll, vp], i32),
        # ops/streamed.py: K10b, K10m (csrc/mixed.cu), K10t
        "gpmp_split_rows": ([vp, vp, vp, vp, ll, ll, ll, ctypes.c_float, vp], i32),
        "gpmp_ff_residual_blocks": ([ll], ll),
        "gpmp_ff_residual": ([vp, vp, vp, vp, vp, vp, vp, ll, i32, vp], i32),
        "gpmp_h_traces_geometry": ([i32], i32),
        "gpmp_h_traces": ([vp, vp, vp, vp, vp, ll, ll, ll, ll, vp], i32),
        "gpmp_diag_block_inv_max_base": ([], i32),
        "gpmp_diag_block_inv": ([vp, vp, ll, i32, vp], i32),
        "gpmp_trace_sums_geometry": ([i32], i32),
        "gpmp_trace_sums": ([vp, vp, vp, vp, vp, ll, ll, ll, ll, vp], i32),
        "gpmp_loo_diag_chunks": ([ll], ll),
        "gpmp_loo_diag_series": ([vp, vp, vp, vp, ll, vp], i32),
        # ops/distance.py: K1d
        "gpmp_distance_geometry": ([i32], i32),
    }
    for suffix in ("f64", "f32"):
        signatures[f"gpmp_distance_{suffix}"] = (
            [vp, vp, vp, vp, ll, ll, i32, ll, ll, ll, vp], i32)
        signatures[f"gpmp_distance_pullback_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, vp, ll, ll, i32, ll, ll, ll, vp], i32)
        signatures[f"gpmp_distance_elementwise_{suffix}"] = ([vp, vp, vp, vp, ll, i32, vp], i32)
        signatures[f"gpmp_distance_elementwise_pullback_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, vp, ll, i32, ll, vp], i32)
        signatures[f"gpmp_maternp_{suffix}"] = ([vp, vp, vp, ll, i32, vp], i32)
        signatures[f"gpmp_maternp_backward_{suffix}"] = ([vp, vp, vp, vp, ll, i32, vp], i32)
        signatures[f"gpmp_loo_diag_pairs_{suffix}"] = ([vp, vp, vp, vp, ll, vp], i32)
        signatures[f"gpmp_matern_gram_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, ll, ll, i32, i32, i32, f64, ll, ll, ll, vp], i32)
        signatures[f"gpmp_matern_pullback_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, ll, i32, i32, i32, f64, ll, ll, ll, vp], i32)
        signatures[f"gpmp_matern_gram_population_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, ll, ll, ll, i32, i32, i32, f64, ll, ll, ll, vp], i32)
        signatures[f"gpmp_matern_pullback_population_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, i32, i32, i32, f64, ll, ll, vp], i32)
        signatures[f"gpmp_residual_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, vp, vp, ll, ll, i32, ll, vp], i32)
        signatures[f"gpmp_precond_apply_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, ll, i32, i32, ll, vp], i32)
        signatures[f"gpmp_precond_apply_slab_{suffix}"] = (
            [vp, vp, vp, vp, vp, vp, ll, ll, ll, i32, i32, ll, vp], i32)
        signatures[f"gpmp_precond_apply_wide_{suffix}"] = ([vp, vp, vp, vp, ll, ll, vp], i32)
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def load():
    """The kernel library, built from the sources on first call (the lock is
    taken only until it is loaded)."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(_compile(build_dir()))))
        return _lib


def launch(name, fn, device, *args):
    """Call a C entry on ``device``'s current stream; raise on its
    cudaGetLastError().  The device is made current only where it is not
    already (the kernel launches on the host thread's current device).  The
    lookups are torch._C's own (a CUDA tensor on ``device`` exists, so CUDA
    is initialised)."""
    index, current = device.index, torch._C._cuda_getDevice()
    if index is None or index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
