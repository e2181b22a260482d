# gpmp_tpu_torch/ops/chol.py
"""The kernels of the blocked Cholesky's factor and of Murray's backward.

Counterparts of parts of gpmp_tpu/parallel/chol.py (the caller is
gpmp_tpu_torch/parallel/chol.py), hand-written CUDA with a plain PyTorch
version and a launch counter each:

- K9u ``trailing_update``: S <- S - T T^T in place on the trailing block of
  the right-looking factor (``_blocked_cholesky_single_unrolled``'s SYRK),
  over its lower tiles, (i, j) and (j, i) from one value
  (gpmp_tpu_torch/csrc/syrk.cu: f64 tensor cores, 128 x 128 tiles listed by
  ``syrk_tiles``; ``K9U_LAUNCHES``);
- K9s ``slab_update``: K9u on one rank's (rows, n) row slab of a
  row-sharded factor (``_sharded_cholesky_impl``'s per-device update
  K_loc[:, w0:] - Mt_loc Mt_all[w0:]^T), the slab's own solved panel times
  the gathered trailing panel rows, over the lower trapezoid: in f64 K9u's
  kernel without the mirror (csrc/syrk.cu; ``K9S_LAUNCHES``), in f32 a
  register-tiled CUDA-core kernel on the same tiles (csrc/syrk_f32.cu;
  ``K9S_F32_LAUNCHES``);
- K9m ``murray_phi`` / ``symmetrize``: Murray's elementwise passes of
  ``_sharded_chol_bwd``, P <- tril(P) - diag(P) / 2 and S <- (S + S^T) / 2,
  in place, on the square matrix or on a slab at a global row offset
  (``murray_phi_slab``; ``symmetrize_slab`` averages a slab with the slab of
  S^T) (gpmp_tpu_torch/csrc/chol.cu; ``K9M_LAUNCHES``).

Each dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); there is no fallback between them.
"""

from __future__ import annotations

import torch

from . import _build, capture
from .mixed import _check_cuda, _on_card, _square

K9U_LAUNCHES = 0
K9S_LAUNCHES = 0
K9S_F32_LAUNCHES = 0
K9M_LAUNCHES = 0

_F64 = torch.float64
_F32 = torch.float32

SYRK_TILE = 128  # K9u/K9s's output tile (csrc/syrk_f64.cuh TILE, csrc/syrk_f32.cu TILE)


def syrk_tiles(n, w0, r0, iend):
    """The launch geometry of K9u and K9s: the global (i0, j0) corners
    of the SYRK_TILE-square output tiles over rows [r0, iend) and columns
    [w0, n) that meet the lower triangle j <= i, as an int32 (count, 2)
    tensor on the CPU (one thread block each; the kernel masks the diagonal
    tiles entrywise).  Row tiles start at r0, column tiles at w0; listed row
    by row."""
    if not (0 <= w0 < n and w0 <= r0 < iend <= n):
        raise ValueError(f"syrk_tiles: rows [{r0}, {iend}) x columns [{w0}, {n}) is not a "
                         "trailing block")
    t = SYRK_TILE
    i0, j0 = torch.meshgrid(torch.arange(r0, iend, t), torch.arange(w0, n, t), indexing="ij")
    keep = j0 <= torch.clamp(i0 + t, max=iend) - 1
    return torch.stack([i0[keep], j0[keep]], 1).to(torch.int32)


@capture.cached(maxsize=256)
def _tiles_on(device, n, w0, r0, iend):
    return syrk_tiles(n, w0, r0, iend).to(device)


def _launch_tiles(lib, device, n, w0, r0, iend):
    if lib.gpmp_syrk_tile() != SYRK_TILE:
        raise RuntimeError(f"csrc/syrk_f64.cuh's tile is {lib.gpmp_syrk_tile()}, "
                           f"not SYRK_TILE = {SYRK_TILE}")
    return _tiles_on(device, n, w0, r0, iend)


def _check_args(name, tensors, dtypes):
    """The dtype and the layout, before the device: a wrong tensor is refused
    for what it is, wherever it lies."""
    for t, dt in zip(tensors, dtypes):
        if t.dtype not in dt:
            raise ValueError(f"{name}: dtype {t.dtype} not in {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


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


def _trailing_update_launch(name, A, c0, b, mma_k=None):
    _check_args(name, (A,), ((_F64,),))
    n = _square(name, A)
    _check_panel(A, c0, b)
    dev = _check_cuda(name, (A,), ((_F64,),))
    lib = _build.load()
    off = int(c0) + int(b)
    tiles = _launch_tiles(lib, dev, n, off, off, n)
    args = (A.data_ptr(), tiles.data_ptr(), tiles.shape[0], n, int(c0), int(b))
    if mma_k is None:
        _build.launch(name, lib.gpmp_trailing_update, dev, *args)
    else:
        _build.launch(name, lib.gpmp_syrk_probe, dev, *args, int(mma_k))
    return A


def trailing_update_cuda(A, c0, b):
    """K9u on the card: the trailing update in place, lower tiles only."""
    global K9U_LAUNCHES
    _trailing_update_launch("K9u trailing_update", A, c0, b)
    K9U_LAUNCHES += 1
    return A


def trailing_update_probe(A, c0, b, mma_k):
    """K9u's kernel at the f64 mma shape m16n8k{mma_k} (mma_k in 4, 8, 16),
    for timing the shapes against each other; counts no launch.  The path
    runs the shape ``_build.load().gpmp_syrk_mma_k()``."""
    return _trailing_update_launch(f"K9u probe m16n8k{mma_k}", A, c0, b, mma_k)


def trailing_update(A, c0, b):
    """In place on A; A must be contiguous on the card (the update writes
    into it)."""
    if _on_card(A):
        return trailing_update_cuda(A, c0, b)
    return trailing_update_plain(A, c0, b)


def _check_slab(A, off, c0, b, Mt):
    rows, n = A.shape
    w0 = c0 + b
    if not (0 <= off and off + rows <= n and 0 <= c0 and b > 0 and w0 < n):
        raise ValueError(f"K9s: slab rows [{off}, {off + rows}) of n={n} and panel "
                         f"[{c0}, {w0}) leave no trailing block")
    if max(off, w0) >= off + rows:
        raise ValueError(f"K9s: slab rows [{off}, {off + rows}) lie above the trailing "
                         f"block at {w0}")
    if Mt.shape != (n, b):
        raise ValueError(f"K9s: Mt must be ({n}, {b}); got {tuple(Mt.shape)}")
    return rows, n


def slab_update_plain(A, off, c0, b, Mt, rows=4096):
    """K9s plain: A[i - off, j] -= A[i - off, c0:c0 + b] . Mt[j] for the slab's
    global rows i >= w0 = c0 + b and columns w0 <= j <= i, in place, by blocks
    of ``rows`` rows (the rectangle left of the block's diagonal square by
    addmm_, the square through its lower triangle); returns A."""
    nrow, _n = _check_slab(A, off, c0, b, Mt)
    w0 = c0 + b
    for r0 in range(max(0, w0 - off), nrow, rows):
        r1 = min(nrow, r0 + rows)
        g0, g1 = off + r0, off + r1
        T = A[r0:r1, c0:w0]
        if g0 > w0:
            A[r0:r1, w0:g0].addmm_(T, Mt[w0:g0].T, alpha=-1.0)
        A[r0:r1, g0:g1].sub_(torch.tril(T @ Mt[g0:g1].T))
    return A


def slab_update_cuda(A, off, c0, b, Mt):
    """K9s on the card: the slab's trailing update in place (one launch) over
    the tiles of ``syrk_tiles``, f64 (K9u's tensor-core kernel) or f32 (a
    register-tiled CUDA-core kernel); A and Mt of one dtype."""
    global K9S_LAUNCHES, K9S_F32_LAUNCHES
    name = "K9s slab_update"
    dtypes = ((_F64, _F32), (A.dtype,))
    _check_args(name, (A, Mt), dtypes)
    rows, n = _check_slab(A, off, c0, b, Mt)
    dev = _check_cuda(name, (A, Mt), dtypes)
    lib = _build.load()
    off, c0, b = int(off), int(c0), int(b)
    if A.dtype == _F32 and lib.gpmp_syrk_f32_tile() != SYRK_TILE:
        raise RuntimeError(f"csrc/syrk_f32.cu's tile is {lib.gpmp_syrk_f32_tile()}, "
                           f"not SYRK_TILE = {SYRK_TILE}")
    tiles = _launch_tiles(lib, dev, n, c0 + b, max(off, c0 + b), off + rows)
    fn = lib.gpmp_slab_update_f64 if A.dtype == _F64 else lib.gpmp_slab_update_f32
    _build.launch(name, fn, dev, A.data_ptr(), Mt.data_ptr(), tiles.data_ptr(), tiles.shape[0],
                  rows, n, off, c0, b)
    if A.dtype == _F64:
        K9S_LAUNCHES += 1
    else:
        K9S_F32_LAUNCHES += 1
    return A


def slab_update(A, off, c0, b, Mt):
    """In place on the slab A; A and Mt must be contiguous on the card."""
    if _on_card(A):
        return slab_update_cuda(A, off, c0, b, Mt)
    return slab_update_plain(A, off, c0, b, Mt)


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


def _check_phi_slab(X, off):
    rows, n = X.shape
    if not (0 <= off and off + rows <= n):
        raise ValueError(f"K9m: slab rows [{off}, {off + rows}) outside n={n}")
    return rows, n


def murray_phi_slab_plain(P, off):
    """K9m plain, phi on the slab of global rows [off, off + rows): zero
    j > i, halve j = i, in place; returns P."""
    _check_phi_slab(P, off)
    P.tril_(off)
    P.diagonal(off).mul_(0.5)
    return P


def symmetrize_slab_plain(S, ST):
    """K9m plain, sym on a slab: S <- (S + ST) / 2 in place, ST the same rows
    of S^T; returns S."""
    S.copy_(0.5 * (S + ST))
    return S


def _murray_slab_cuda(X, Y, off, sym):
    global K9M_LAUNCHES
    name = "K9m symmetrize_slab" if sym else "K9m murray_phi_slab"
    tensors = (X, Y) if sym else (X,)
    dev = _check_cuda(name, tensors, ((_F64,),) * len(tensors))
    rows, n = _check_phi_slab(X, off)
    if sym and Y.shape != X.shape:
        raise ValueError(f"{name}: the slabs differ in shape")
    lib = _build.load()
    _build.launch(name, lib.gpmp_murray_slab, dev, X.data_ptr(), Y.data_ptr() if sym else None,
                  rows, n, int(off), int(sym))
    K9M_LAUNCHES += 1
    return X


def murray_phi_slab(P, off):
    if _on_card(P):
        return _murray_slab_cuda(P, None, off, False)
    return murray_phi_slab_plain(P, off)


def symmetrize_slab(S, ST, off):
    if _on_card(S):
        return _murray_slab_cuda(S, ST, off, True)
    return symmetrize_slab_plain(S, ST)
