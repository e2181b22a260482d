# gpmp_tpu_torch/ops/chol.py
"""The kernels of the blocked Cholesky's factor and of Murray's backward.

Counterparts of parts of gpmp_tpu/parallel/chol.py (the caller is
gpmp_tpu_torch/parallel/chol.py), hand-written CUDA with a plain PyTorch
version and a launch counter each:

- K9u ``trailing_update``: S <- S - T T^T in place on the trailing block of
  the right-looking factor (``_blocked_cholesky_single_unrolled``'s SYRK),
  over its lower tiles, (i, j) and (j, i) from one value
  (gpmp_tpu_torch/csrc/mixed.cu: K4's kernel with f64 L, a k range and
  in-place output; ``K9U_LAUNCHES``);
- K9m ``murray_phi`` / ``symmetrize``: Murray's elementwise passes of
  ``_sharded_chol_bwd``, P <- tril(P) - diag(P) / 2 and S <- (S + S^T) / 2,
  in place (gpmp_tpu_torch/csrc/chol.cu; ``K9M_LAUNCHES``).

Each dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); there is no fallback between them.
"""

from __future__ import annotations

import torch

from . import _build
from .mixed import _check_cuda, _on_card, _square

K9U_LAUNCHES = 0
K9M_LAUNCHES = 0

_F64 = torch.float64


def _check_panel(A, c0, b):
    n = A.shape[0]
    if not (0 <= c0 and b > 0 and c0 + b < n):
        raise ValueError(f"K9u: panel [{c0}, {c0 + b}) leaves no trailing block in n={n}")
    return n


def trailing_update_plain(A, c0, b, rows=4096):
    """K9u plain: A[off:, off:] <- S - T T^T (off = c0 + b, T = A[off:, c0:off],
    S = A[off:, off:]) from the lower triangle, mirrored: exactly symmetric.
    In place, by blocks of ``rows`` rows (no (n, n) temporary: at n = 51200
    one would not fit beside A on an 80 GB card); returns A."""
    _check_panel(A, c0, b)
    off = c0 + b
    T = A[off:, c0:off]
    S = A[off:, off:]
    m = S.shape[0]
    for r0 in range(0, m, rows):  # the lower block rows, through the diagonal
        r1 = min(m, r0 + rows)
        S[r0:r1, :r1].addmm_(T[r0:r1], T[:r1].T, alpha=-1.0)
    for r0 in range(0, m, rows):  # mirror the lower triangle
        r1 = min(m, r0 + rows)
        D = S[r0:r1, r0:r1]
        D.copy_(torch.tril(D) + torch.tril(D, -1).T)
        S[r0:r1, r1:] = S[r1:, r0:r1].T
    return A


def trailing_update_cuda(A, c0, b):
    """K9u on the card: the trailing update in place, lower tiles only."""
    global K9U_LAUNCHES
    dev = _check_cuda("K9u trailing_update", (A,), ((_F64,),))
    n = _square("K9u trailing_update", A)
    _check_panel(A, c0, b)
    lib = _build.load()
    _build.launch("K9u trailing_update", lib.gpmp_trailing_update, dev, A.data_ptr(), n,
                  int(c0), int(b))
    K9U_LAUNCHES += 1
    return A


def trailing_update(A, c0, b):
    """In place on A; A must be contiguous on the card (the update writes
    into it)."""
    if _on_card(A):
        return trailing_update_cuda(A, c0, b)
    return trailing_update_plain(A, c0, b)


def murray_phi_plain(P):
    """K9m plain, phi: P <- tril(P) - diag(P) / 2, in place; returns P."""
    P.copy_(torch.tril(P))
    P.diagonal().mul_(0.5)
    return P


def symmetrize_plain(S):
    """K9m plain, sym: S <- (S + S^T) / 2, in place; returns S."""
    S.copy_(0.5 * (S + S.T))
    return S


def _murray_cuda(X, sym):
    global K9M_LAUNCHES
    name = "K9m symmetrize" if sym else "K9m murray_phi"
    dev = _check_cuda(name, (X,), ((_F64,),))
    n = _square(name, X)
    lib = _build.load()
    _build.launch(name, lib.gpmp_murray, dev, X.data_ptr(), n, int(sym))
    K9M_LAUNCHES += 1
    return X


def murray_phi_cuda(P):
    """K9m on the card, phi, in place."""
    return _murray_cuda(P, False)


def symmetrize_cuda(S):
    """K9m on the card, sym, in place."""
    return _murray_cuda(S, True)


def murray_phi(P):
    if _on_card(P):
        return murray_phi_cuda(P)
    return murray_phi_plain(P)


def symmetrize(S):
    if _on_card(S):
        return symmetrize_cuda(S)
    return symmetrize_plain(S)
