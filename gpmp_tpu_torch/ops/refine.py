# gpmp_tpu_torch/ops/refine.py
"""f64-accurate factors from f32 factorizations + f64 products.

Counterpart of gpmp_tpu/ops/refine.py.  Two users:

1. The sampling square root of the mixed engine, C C^T = K to ~1e-9
   (``sampling_sqrt``):

    L32 = chol_f32(K + ridge), M32 = L32^{-1}  (the mixed engine's f32
                                               preconditioner: cholesky_ex, K5)
    E   = K - L L^T                            (K8s, f64, L = L32 promoted)
    Dt  = M (E M^T)                            (f64 torch.matmul)
    C   = L + L Dt / 2                         (torch.addmm)

   C is not triangular; C C^T = K + L (Dt^2 / 4) L^T, and any such root
   draws paths with covariance C C^T.  The guard sum Dt^2 < 1e2 turns
   runaway cases into NaN; a non-PD K is already NaN through the f32
   Cholesky.

2. The refined panels of the blocked Cholesky (gpmp_tpu_torch/parallel/
   chol.py): ``refined_cholesky`` factors a (B, B) f64 panel from one f32
   Cholesky and f64 products,

    L0 = chol_f32(A), M = trisolve_f32(L0, I)
    M <- M (2I - L0 M)                          (Newton, ``newton_tri_inv``)
    E  = A - L L^T                              (K8r)
    L <- L + L Phi(M E M^T), M <- M (2I - L M)  (Ogita-Aishima, twice)

   with the guard |A - L L^T|_F^2 / |A|_F^2 < 1e-16 (K8r's sums) turning an
   unconverged factor into NaN; ``refined_solve_lower`` solves a panel
   T L^T = B with the refined inverse and one residual sweep
   (torch.matmul, as the JAX package's jnp.dot).

Hand-written CUDA (gpmp_tpu_torch/csrc/mixed.cu and csrc/chol.cu), each
with a plain PyTorch version and a launch counter:

- K8s ``sampling_residual``: K4's kernel with an output in K's dtype; it
  launches only the lower 32 x 32 tiles, stops each tile's k loop at its
  last column, and writes (i, j) and (j, i) from one value, so E is exactly
  symmetric (``K8S_LAUNCHES``);
- K8r ``refine_residual``: the same kernel with f64 L, plus the guard's
  sums of E^2 and A^2 in a fixed order (``K8R_LAUNCHES``);
- K8t ``tri_product``: C = beta A + alpha A f(B) over the lower tiles only,
  f(B) = tril(B) or Phi(B), the upper triangle exact zeros: the two
  products of a Newton step and the Ogita-Aishima update
  (``K8T_LAUNCHES``).

Each dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); there is no fallback between them.
JAX's ``jnp.linalg.cholesky`` and ``solve_triangular`` of the f32 panel are
``torch.linalg.cholesky_ex`` (a failed factorization is NaN, never an
exception) and ``torch.linalg.solve_triangular``.
"""

from __future__ import annotations

import torch

from . import _build
from .mixed import _F32, _check_cuda, _f32_preconditioner, _on_card, _square

K8S_LAUNCHES = 0
K8R_LAUNCHES = 0
K8T_LAUNCHES = 0
# sum Dt^2 above this turns the root into NaN (gpmp_tpu/ops/refine.py:116)
_SQRT_GUARD = 1e2
# relative Frobenius residual^2 acceptance of the refined factor
# (gpmp_tpu/ops/refine.py:39), kept for parity.  The JAX package set it
# against the TPU's emulated-f64 products; with the card's native f64 a
# converged panel should read far below it (chip_smoke.py prints it).
_FACTOR_RTOL2 = 1e-16
_F64 = torch.float64


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


# ----------------------------------------------------------------------------
# The refined panels of the blocked Cholesky: K8r, K8t
# ----------------------------------------------------------------------------
def refine_residual_plain(A, L):
    """K8r plain: (E = A - L L^T, exactly symmetric from its lower triangle,
    [sum E^2, sum A^2]) in f64."""
    E = torch.tril(A - L @ L.T)
    E = E + torch.tril(E, -1).T
    return E, torch.stack([torch.sum(E * E), torch.sum(A * A)])


def refine_residual_cuda(A, L):
    """K8r on the card: (symmetric E = A - L L^T, [sum E^2, sum A^2]), f64."""
    global K8R_LAUNCHES
    dev = _check_cuda("K8r refine_residual", (A, L), ((_F64,), (_F64,)))
    n = _square("K8r refine_residual", A)
    if L.shape != A.shape:
        raise ValueError(f"K8r: L must be {tuple(A.shape)}; got {tuple(L.shape)}")
    lib = _build.load()
    E = torch.empty_like(A)
    partial = torch.empty((lib.gpmp_refine_residual_blocks(n), 2), dtype=_F64, device=dev)
    sums = torch.empty(2, dtype=_F64, device=dev)
    _build.launch("K8r refine_residual", lib.gpmp_refine_residual, dev, A.data_ptr(),
                  L.data_ptr(), E.data_ptr(), partial.data_ptr(), sums.data_ptr(), n)
    K8R_LAUNCHES += 1
    return E, sums


def refine_residual(A, L):
    if _on_card(A):
        return refine_residual_cuda(A.contiguous(), L.contiguous())
    return refine_residual_plain(A, L)


def _phi(X):
    """Lower triangle with halved diagonal."""
    return torch.tril(X) - 0.5 * torch.diag(torch.diag(X))


def tri_product_plain(A, B, beta=0.0, alpha=1.0, phi=False):
    """K8t plain: tril(beta A + alpha tril(A) f(B)), f(B) = Phi(B) if phi
    else tril(B)."""
    fB = _phi(B) if phi else torch.tril(B)
    return torch.tril(beta * A + alpha * (torch.tril(A) @ fB))


def tri_product_cuda(A, B, beta=0.0, alpha=1.0, phi=False):
    """K8t on the card: beta A + alpha A f(B) over the lower tiles, f64."""
    global K8T_LAUNCHES
    dev = _check_cuda("K8t tri_product", (A, B), ((_F64,), (_F64,)))
    n = _square("K8t tri_product", A)
    if B.shape != A.shape:
        raise ValueError(f"K8t: B must be {tuple(A.shape)}; got {tuple(B.shape)}")
    lib = _build.load()
    C = torch.empty_like(A)
    _build.launch("K8t tri_product", lib.gpmp_tri_product, dev, A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), n, float(beta), float(alpha), int(bool(phi)))
    K8T_LAUNCHES += 1
    return C


def tri_product(A, B, beta=0.0, alpha=1.0, phi=False):
    if _on_card(A):
        return tri_product_cuda(A.contiguous(), B.contiguous(), beta, alpha, phi)
    return tri_product_plain(A, B, beta, alpha, phi)


def newton_tri_inv(L, M, steps=1):
    """Newton iteration M <- M (2I - L M) = 2M - M (L M) for the inverse of a
    lower triangular f64 L; quadratically convergent, two K8t products per
    step, exactly triangular."""
    for _ in range(steps):
        M = tri_product(M, tri_product(L, M), beta=2.0, alpha=-1.0)
    return M


def _f32_inverse(L32):
    """L32^{-1} by the f32 triangular solve with an identity right-hand side
    (the JAX package's op)."""
    eye = torch.eye(L32.shape[0], dtype=_F32, device=L32.device)
    return torch.linalg.solve_triangular(L32, eye, upper=False)


def refined_cholesky(A, steps=2, with_inverse=False, rtol2=_FACTOR_RTOL2):
    """f64-accurate lower Cholesky factor of SPD A via f32 + refinement.

    Returns L, or (L, M ~= L^{-1}) with with_inverse=True.  NaN when the f32
    factorization fails (non-PD) or the final relative factor residual^2
    reaches ``rtol2``: 3 K8r and 2 + 3 steps K8t launches, no host read."""
    L32, info = torch.linalg.cholesky_ex(A.to(_F32))
    L32 = torch.where(info == 0, L32, torch.nan)
    L = L32.to(A.dtype)
    M = newton_tri_inv(L, _f32_inverse(L32).to(A.dtype), steps=1)
    for _ in range(steps):
        E, _sums = refine_residual(A, L)
        L = tri_product(L, M @ E @ M.T, beta=1.0, alpha=1.0, phi=True)
        M = newton_tri_inv(L, M, steps=1)
    # convergence guard: the final factor residual must be ~f64-small
    _E, sums = refine_residual(A, L)
    err2 = sums[0] / torch.clamp(sums[1], min=torch.finfo(A.dtype).tiny)
    ok = err2 < rtol2
    L = torch.where(ok, L, torch.nan)
    if with_inverse:
        return L, torch.where(ok, M, torch.nan)
    return L


def refined_solve_lower(L, M, B, n_refine=1):
    """T solving T L^T = B (right triangular solve) as products:
    T0 = B M^T, then residual refinement T += (B - T L^T) M^T."""
    T = B @ M.T
    for _ in range(n_refine):
        T = T + (B - T @ L.T) @ M.T
    return T
