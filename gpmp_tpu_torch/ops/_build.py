# gpmp_tpu_torch/ops/_build.py
"""Build the CUDA sources under gpmp_tpu_torch/csrc at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` compiles every ``csrc/*.cu`` into one shared library
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

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "gpmp_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall-clock of this process's build, None if not built here


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    lib_path = out_dir / "libgpmp_tpu_torch.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    # build into a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, f"-I{_CSRC}", "-o", tmp, *cu],
        capture_output=True, text=True,
    )
    global build_seconds
    build_seconds = time.perf_counter() - t0
    (out_dir / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def _declare(lib):
    vp, ll, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    lib.gpmp_matern_max_d.argtypes = []
    lib.gpmp_matern_max_d.restype = i32
    lib.gpmp_matern_pullback_blocks.argtypes = [ll, ll]
    lib.gpmp_matern_pullback_blocks.restype = ll
    for suffix in ("f64", "f32"):
        fn = getattr(lib, f"gpmp_matern_gram_{suffix}")
        fn.argtypes = [vp, vp, vp, vp, vp, ll, ll, i32, i32, i32, f64, vp]
        fn.restype = i32
        fn = getattr(lib, f"gpmp_matern_pullback_{suffix}")
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ll, i32, i32, i32, f64, vp]
        fn.restype = i32
    return lib


def load():
    """The kernel library, built from the sources on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(_compile(build_dir()))))
        return _lib
