# gpmp_tpu_torch/ops/refine.py
"""The sampling square root of the mixed engine: C C^T = K to ~1e-9.

Counterpart of gpmp_tpu/ops/refine.py ``sampling_sqrt``:

    L32 = chol_f32(K + ridge), M32 = L32^{-1}  (the mixed engine's f32
                                               preconditioner: cholesky_ex, K5)
    E   = K - L L^T                            (K8s, f64, L = L32 promoted)
    Dt  = M (E M^T)                            (f64 torch.matmul)
    C   = L + L Dt / 2                         (torch.addmm)

C is not triangular; C C^T = K + L (Dt^2 / 4) L^T, and any such root draws
paths with covariance C C^T.  The guard sum Dt^2 < 1e2 turns runaway cases
into NaN; a non-PD K is already NaN through the f32 Cholesky.

K8s (``sampling_residual_cuda``) is hand-written CUDA
(gpmp_tpu_torch/csrc/mixed.cu, K4's kernel with an output in K's dtype): it
launches only the lower 32 x 32 tiles, stops each tile's k loop at its last
column, and writes (i, j) and (j, i) from one value, so E is exactly
symmetric.  ``sampling_residual`` dispatches on the device: the plain
version (``sampling_residual_plain``) for CPU tensors, the kernel for CUDA
tensors, no fallback between them.  ``K8S_LAUNCHES`` counts its launches.

``refined_cholesky``, ``newton_tri_inv`` and ``refined_solve_lower`` of the
JAX module serve only the sharded Cholesky (gpmp_tpu/parallel/chol.py) and
are not ported yet (ROADMAP queue 2, K8/K9).
"""

from __future__ import annotations

import torch

from . import _build
from .mixed import _F32, _check_cuda, _f32_preconditioner, _on_card, _square

K8S_LAUNCHES = 0
# sum Dt^2 above this turns the root into NaN (gpmp_tpu/ops/refine.py:116)
_SQRT_GUARD = 1e2


def sampling_residual_plain(K, L32):
    """K8s plain: K - L L^T in K's dtype (L = L32 promoted); the lower
    triangle is kept and mirrored, so the result is exactly symmetric."""
    L = L32.to(K.dtype)
    E = torch.tril(K - L @ L.T)
    return E + torch.tril(E, -1).T


def sampling_residual_cuda(K, L32):
    """K8s on the card: symmetric K - L L^T in K's dtype from the lower triangle."""
    global K8S_LAUNCHES
    dev = _check_cuda("K8s sampling_residual", (K, L32),
                      ((torch.float64, torch.float32), (_F32,)))
    n = _square("K8s sampling_residual", K)
    if L32.shape != K.shape:
        raise ValueError(f"K8s: L must be {tuple(K.shape)}; got {tuple(L32.shape)}")
    lib = _build.load()
    out = torch.empty((n, n), dtype=K.dtype, device=dev)
    fn = (lib.gpmp_sampling_residual_f64 if K.dtype == torch.float64
          else lib.gpmp_sampling_residual_f32)
    _build.launch("K8s sampling_residual", fn, dev, K.data_ptr(), L32.data_ptr(),
                  out.data_ptr(), n)
    K8S_LAUNCHES += 1
    return out


def sampling_residual(K, L32):
    if _on_card(K):
        return sampling_residual_cuda(K.contiguous(), L32.contiguous())
    return sampling_residual_plain(K, L32)


def sampling_sqrt(K):
    """C with C C^T ~= K (relative error ~1e-9): the sampling factor; NaN
    where the f32 factorization fails or the guard does."""
    L32, M32 = _f32_preconditioner(K)
    L, M = L32.to(K.dtype), M32.to(K.dtype)
    Dt = M @ (sampling_residual(K, L32) @ M.T)
    ok = torch.sum(Dt * Dt) < _SQRT_GUARD
    return torch.where(ok, torch.addmm(L, L, Dt, alpha=0.5), torch.nan)
