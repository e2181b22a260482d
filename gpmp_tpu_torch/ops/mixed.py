# gpmp_tpu_torch/ops/mixed.py
"""Mixed-precision Cholesky engine: f32 factorization + f64 refinement.

Counterpart of gpmp_tpu/ops/mixed.py (the 'mixed' engine of
``config.set_chol_engine``).  The algorithm is the JAX package's:

1. L32 = chol_f32(K + ridge), ridge = 10 eps32 mean(diag K)
   (``torch.linalg.cholesky_ex``: a non-PD K gives NaN, never an
   exception), and M = L32^{-1} in f32 by recursive 2x2 blocking;
2. K x = b by iterative refinement x += M^T M (b - K x), the residual in
   f64, with the early exit and the convergence guard of the JAX version;
3. log det K = 2 sum log diag L32 + log det(I + H), H = M (K - L L^T) M^T,
   by a quartic trace series (or a second f32 factorization of I + H when
   |H|_F^2 >= 1e-4);
4. an analytic backward: Kbar = ldbar K^{-1} - S X^T, Bbar = S, with
   S = K^{-1} Xbar one refined solve on the saved preconditioner;
5. the LOO block (K^{-1} B, diag K^{-1}) from the series
   K^{-1} ~= M^T (I - D + D^2) M, with the analytic backward
   Kbar = -K^{-1} diag(dbar) K^{-1} - S X^T, Bbar = S.

Six pieces are hand-written CUDA kernels (gpmp_tpu_torch/csrc/mixed.cu; K4
and K4s in csrc/residual.cu), each with a plain PyTorch version here and a
launch counter:

- K3 ``residual``: R = B - K X and (sum R^2, sum B^2) for k <= 8 columns
  (``_f64_matvec`` plus the residual norms of ``refined_cholesky_solve``);
- K6 ``_apply`` (``precond_apply_*``): the preconditioner application
  M^T (M r) for any number of columns, r rounded to f32, f32 products,
  cast back (k <= 8: two bandwidth-bound passes, ``precond_plan``);
- K4 ``factorization_residual``: R = K - L L^T over the lower triangle in
  f64, emitted in f32 and made symmetric (``_factorization_residual_f32``),
  on the f64 tensor cores over the tiles of ``residual_tiles``;
- K5 ``diag_block_inv``: the inverses of the diagonal blocks of L32
  (the base case of ``_block_tri_inv``), by substitution on 8-wide leaves
  and doubling levels in shared memory;
- K7 ``trace_sums`` / ``series_sums``: (tr H, sum H^2) and
  (sum H^2 o H, sum (H^2)^2) accumulated in f64 from f32 H and H^2 (the
  trace series of ``_mp_solve_and_logdet_core``), one bandwidth-bound
  launch each on the grid of ``trace_sums_plan``;
- K7b ``loo_diag_series`` / ``loo_diag_pairs``: the column sums
  diag K^{-1} = sum_i M_ij^2 - sum_i M_ij B_ij (series) or sum_i G_ij W_ij
  (two-level) in f64 (``mp_solve_and_inv_diag``).

K3 and K7 also take a rank's (rows, n) row slab of a row-sharded K or H
(``residual`` on a slab; ``trace_sums(H, off)``, ``series_sums``), K6 a
slab of M and all of r (``precond_apply_slab``: that rank's part of
M^T (M r), in f32), and K4s, K4's kernel on one column block of a rank's
rows of K - L L^T (``factorization_residual_slab``, tiles of
``residual_slab_tiles``, ``K4S_LAUNCHES``): the sharded mixed engine on a
group mesh (gpmp_tpu_torch/parallel/mixed.py).

Each dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); there is no fallback between them.
The matrix products around the kernels (H = M R M^T, H @ H, the recursion
levels of the triangular inverse, and K X for more than 8 columns) are
``torch.matmul``, as the JAX package left them to XLA's dot.

JAX's ``lax.while_loop`` and ``lax.cond`` become host branches: a refined
solve reads its residual norm once per sweep (1 + sweeps reads), and the
logdet reads tr H^2 once to choose the branch.  A REML value+grad on this
engine therefore makes (1 + s_fwd) + 1 + (1 + s_bwd) reads of the device,
plus the criterion's own one; s is 1 or 2 sweeps for a well-conditioned K.

The forward-mode twins of the JAX module (``mp_solve_and_logdet_fwdmode``,
``refined_solve_fwdmode``, ``is_fwd_mode_error``) are not ported: the
autograd Functions here have no ``jvp`` (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import functools
import math

import torch

from .autograd import first_order_only
from . import _build, capture

DEFAULT_REFINE_ITERS = 4
_RIDGE_FACTOR = 10.0
# relative-residual^2 acceptance for refined solves: rel < 1e-6
_SOLVE_RTOL2 = 1e-12
# early exit of the refinement: residual^2 floor
_REFINE_FLOOR2 = 1e-24
# |E2 - I|_F^2 acceptance for the two-level logdet expansion
_LOGDET_FTOL2 = 1e-8
# |H|_F^2 threshold of the single-level quartic trace series
_SERIES_TAU = 1e-4
# K3 takes at most this many right-hand sides; wider ones use torch.matmul
MATVEC_MAX_COLS = 8
# diagonal block size of the triangular inverse (K5), and the leaves K5
# inverts by substitution before its doubling levels
TRI_INV_BASE = 128
TRI_INV_LEAF = 8

K3_LAUNCHES = 0
K4_LAUNCHES = 0
K4S_LAUNCHES = 0
K5_LAUNCHES = 0
K7_LAUNCHES = 0
K7B_LAUNCHES = 0
K6_LAUNCHES = 0

_F32 = torch.float32


# ----------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are held to)
# ----------------------------------------------------------------------------
def residual_plain(K, X, B):
    """K3 plain: (R = B - K X, [sum R^2, sum B^2]).

    K X as multiply + reduce, one column at a time (the JAX package's
    ``_f64_matvec`` for skinny X)."""
    KX = torch.stack([torch.sum(K * X[:, j], dim=1) for j in range(X.shape[1])], dim=1)
    R = B - KX
    return R, torch.stack([torch.sum(R * R), torch.sum(B * B)]).double()


def precond_apply_plain(M32, R):
    """K6 plain: M^T (M r32) in f32 with r32 = f32(R), cast to R's dtype (two
    torch.matmul, as the JAX package's two jnp.dot)."""
    return (M32.T @ (M32 @ R.to(_F32))).to(R.dtype)


def factorization_residual_plain(K, L32):
    """K4 plain: K - L L^T in K's dtype, cast to f32; the lower triangle
    is kept and mirrored, so the result is exactly symmetric."""
    L = L32.to(K.dtype)
    T = torch.tril((K - L @ L.T).to(_F32))
    return T + torch.tril(T, -1).T


def _diag_blocks(L, base):
    """(nb, base, base) diagonal blocks of L; a ragged last block is
    completed with the identity."""
    n = L.shape[0]
    nb, full = -(-n // base), n // base
    blocks = torch.eye(base, dtype=L.dtype, device=L.device).repeat(nb, 1, 1)
    if full:
        # views of the full blocks: [a, r, c] = L[a base + r, a base + c]
        blocks[:full] = L[:full * base, :full * base].unfold(0, base, base).unfold(
            1, base, base).diagonal(0, 0, 1).permute(2, 0, 1)
    if full < nb:
        blocks[full, : n - full * base, : n - full * base] = L[full * base:, full * base:]
    return blocks


def tri_inv_size(base):
    """K5's working size for a base: the smallest TRI_INV_LEAF * 2^m >= base
    (each block is completed with the identity to it; its inverse is the
    block's inverse completed the same way)."""
    size = TRI_INV_LEAF
    while size < base:
        size *= 2
    return size


def diag_block_inv_plain(L32, base):
    """K5 plain: inverses of the diagonal blocks of lower-triangular L32,
    (ceil(n / base), base, base), a ragged last block padded with the
    identity; exact zeros above the diagonal.  The kernel's order, all
    blocks at once: each block (its lower triangle) completed with the
    identity to tri_inv_size(base); its TRI_INV_LEAF-wide diagonal leaves
    inverted by row-by-row substitution; then the doubling levels s =
    TRI_INV_LEAF, 2 TRI_INV_LEAF, ...: for each pair of s-blocks,
    T = A21 X11 and X21 = -(X22 T) (the 2x2 identity of _block_tri_inv)."""
    A = torch.tril(_diag_blocks(L32, base))
    nb, size, leaf = A.shape[0], tri_inv_size(base), TRI_INV_LEAF
    if size != base:
        Ap = torch.eye(size, dtype=A.dtype, device=A.device).repeat(nb, 1, 1)
        Ap[:, :base, :base] = A
        A = Ap

    def diagonal_blocks(s):  # (nb, size / s, s, s)
        m = size // s
        return A.reshape(nb, m, s, m, s).diagonal(0, 1, 3).permute(0, 3, 1, 2)

    # the leaves: X[c, c] = 1 / A[c, c]; X[i, c] = -(sum_{c <= k < i} A[i, k]
    # X[k, c]) / A[i, i] below (X[k, c] = 0 for k < c, so the sum runs over
    # all k < i)
    Lf = diagonal_blocks(leaf)
    X = torch.zeros_like(Lf)
    for i in range(leaf):
        s = torch.einsum("...k,...kc->...c", Lf[..., i, :i], X[..., :i, :i])
        X[..., i, :i] = -s / Lf[..., i, i:i + 1]
        X[..., i, i] = 1 / Lf[..., i, i]
    s = leaf
    while s < size:
        C = diagonal_blocks(2 * s)[..., s:, :s]
        X11, X22 = X[:, 0::2], X[:, 1::2]
        X21 = -(X22 @ (C @ X11))
        X = torch.cat([torch.cat([X11, torch.zeros_like(X11)], -1),
                       torch.cat([X21, X22], -1)], -2)
        s *= 2
    return X[:, 0, :base, :base]


def trace_sums_plain(H, off=0):
    """K7 plain, first call: [tr H, sum H^2] in f64 from f32 H (on a row
    slab of global rows [off, off + rows): its part of both)."""
    H64 = H.double()
    return torch.stack([torch.sum(torch.diagonal(H64, off)), torch.sum(H64 * H64)])


def series_sums_plain(H, H2):
    """K7 plain, second call: [sum H^2 o H, sum (H^2)^2] in f64."""
    H64, H2_64 = H.double(), H2.double()
    return torch.stack([torch.sum(H2_64 * H64), torch.sum(H2_64 * H2_64)])


def precond_apply_slab_plain(M32, R):
    """K6 plain, slab form: M_loc^T (M_loc r32) in f32, M_loc (rows, n) a row
    slab of M, r (n, k): this rank's part of M^T (M r)."""
    return M32.T @ (M32 @ R.to(_F32))


def factorization_residual_slab_plain(K, La, Lb, offs, R):
    """K4s plain: R[:, offs:offs + rows_b] = f32(K[:, offs:offs + rows_b] -
    La Lb^T) in f64; returns R."""
    rows_b = Lb.shape[0]
    R[:, offs:offs + rows_b] = (K[:, offs:offs + rows_b] - La.double() @ Lb.double().T).to(_F32)
    return R


def loo_diag_series_plain(M32, B32, dtype):
    """K7b plain, series branch: sum_i M_ij^2 - sum_i M_ij B_ij in ``dtype``,
    with the JAX package's arithmetic: the squares of M (M32 promoted) in
    ``dtype``, the correction summed in f32."""
    M = M32.to(dtype)
    return torch.sum(M * M, dim=0) - torch.sum(M32 * B32, dim=0).to(dtype)


def loo_diag_pairs_plain(G, W):
    """K7b plain, two-level branch: sum_i G_ij W_ij."""
    return torch.sum(G * W, dim=0)


# ----------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ----------------------------------------------------------------------------
def _check_cuda(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if t.dtype not in dt:
            raise ValueError(f"{name}: dtype {t.dtype} not in {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    return dev


def _square(name, A):
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] == 0:
        raise ValueError(f"{name}: expected a non-empty square matrix, got {tuple(A.shape)}")
    return A.shape[0]


# K3's launch geometry (csrc/mixed.cu): blocks of RESIDUAL_BLOCK_ROWS rows
# (8 warps of 4), each row's columns cut into chunks of whole
# RESIDUAL_STEP-column warp steps; enough chunks that the grid holds about
# RESIDUAL_BLOCKS_PER_SM blocks per SM (two run at once on an SM at the
# engine's k = 2)
RESIDUAL_BLOCK_ROWS, RESIDUAL_STEP, RESIDUAL_BLOCKS_PER_SM = 32, 128, 2


def residual_column_chunks(rows, n, sms):
    """K3's column split of a (rows, n) K, on the CPU: (chunks, width), each
    row's columns [0, n) cut into ``chunks`` chunks [c w, min((c + 1) w, n)),
    w a multiple of RESIDUAL_STEP, none empty; as many as the grid of row
    blocks needs to reach RESIDUAL_BLOCKS_PER_SM blocks on each of ``sms``
    SMs, at most one a step (n = 1000 on the H100's 132 SMs: 8 chunks of
    128; n = 16384: one)."""
    if rows <= 0 or n <= 0 or sms <= 0:
        raise ValueError(f"residual_column_chunks: rows={rows}, n={n}, sms={sms}")
    row_blocks = -(-rows // RESIDUAL_BLOCK_ROWS)
    steps = -(-n // RESIDUAL_STEP)
    want = max(1, min(steps, -(-RESIDUAL_BLOCKS_PER_SM * sms // row_blocks)))
    width = RESIDUAL_STEP * -(-steps // want)
    return -(-n // width), width


def _residual_geometry(lib):
    built = (lib.gpmp_residual_geometry(0), lib.gpmp_residual_geometry(1))
    if built != (RESIDUAL_BLOCK_ROWS, RESIDUAL_STEP):
        raise RuntimeError(f"csrc/mixed.cu's K3 geometry (rows a block, columns a step) is "
                           f"{built}, not {(RESIDUAL_BLOCK_ROWS, RESIDUAL_STEP)}")


@functools.lru_cache(maxsize=16)
def _sms_on(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@capture.cached(maxsize=64)
def _residual_workspace(device, rows, n, k):
    """K3's per-(device, rows, n, k) workspace: the chunk width, and raw
    pointers to the chunks' partial sums and the row blocks' pairs (f64)
    and to the tickets (int32, zero between launches: each launch resets
    them), beside the tensors that hold them."""
    _residual_geometry(_build.load())
    chunks, width = residual_column_chunks(rows, n, _sms_on(device))
    row_blocks = -(-rows // RESIDUAL_BLOCK_ROWS)
    part = torch.empty(chunks * rows * k + 2 * row_blocks, dtype=torch.float64, device=device)
    tickets = torch.zeros(row_blocks + 1, dtype=torch.int32, device=device)
    return (width, part.data_ptr(), part.data_ptr() + 8 * chunks * rows * k,
            tickets.data_ptr(), (part, tickets))


def residual_cuda(K, X, B):
    """K3 on the card: (R = B - K X, [sum R^2, sum B^2] in f64), K (n, n) or
    a (rows, n) row slab with B and R its rows.

    One launch: per-chunk partial sums, combined in chunk order with the
    norms by the last blocks to finish (bitwise reproducible)."""
    global K3_LAUNCHES
    fp = (torch.float64, torch.float32)
    dev = _check_cuda("K3 residual", (K, X, B), (fp, (K.dtype,), (K.dtype,)))
    if K.ndim != 2 or K.shape[0] == 0 or K.shape[0] > K.shape[1]:
        raise ValueError(f"K3 residual: K must be (rows <= n, n); got {tuple(K.shape)}")
    rows, n = K.shape
    if X.ndim != 2 or B.ndim != 2 or X.shape[0] != n or B.shape != (rows, X.shape[1]):
        raise ValueError(f"K3 residual: X must be ({n}, k), B ({rows}, k); got "
                         f"{tuple(X.shape)}, {tuple(B.shape)}")
    k = X.shape[1]
    if not 1 <= k <= MATVEC_MAX_COLS:
        raise ValueError(f"K3 residual takes 1..{MATVEC_MAX_COLS} columns; got {k}")
    width, part, pairs, tickets, _ = _residual_workspace(dev, rows, n, k)
    lib = _build.load()
    R = torch.empty((rows, k), dtype=K.dtype, device=dev)
    norms = torch.empty(2, dtype=torch.float64, device=dev)
    fn = lib.gpmp_residual_f64 if K.dtype == torch.float64 else lib.gpmp_residual_f32
    _build.launch("K3 residual", fn, dev, K.data_ptr(), X.data_ptr(), B.data_ptr(),
                  R.data_ptr(), part, pairs, tickets, norms.data_ptr(), rows, n, k, width)
    K3_LAUNCHES += 1
    return R, norms


# K6's launch geometry (csrc/mixed.cu), k <= 8 columns: pass 1 (y = M r32)
# gives each warp PRECOND_ROWS rows, PRECOND_WARPS warps a block, or fewer
# where its blocks would not reach PRECOND_BLOCKS_PER_SM an SM; pass 2
# (M^T y) gives each block of PRECOND_WARPS warps a band of PRECOND_BAND
# columns and a chunk of rows, whole steps of PRECOND_WARPS * PRECOND_ROWS
# rows, enough chunks that the blocks of the triangle reach
# PRECOND_BLOCKS_PER_SM an SM and none taller than PRECOND_MAX_CHUNK
PRECOND_ROWS, PRECOND_BAND, PRECOND_WARPS = 4, 128, 8
PRECOND_BLOCKS_PER_SM, PRECOND_MAX_CHUNK = 2, 1024


def precond_plan(rows, n, sms):
    """K6's launch geometry for a (rows, n) slab of M (rows = n: the square
    M), on the CPU: (warps, chunks, height) -- pass 1's warps a block, and
    pass 2's row chunks [c h, min((c + 1) h, rows)), h a multiple of the
    block step, none empty (n = 1000 on the H100's 132 SMs: 1 warp a
    block, 32 chunks of 32 rows; n = 32768: 8 warps, 32 chunks of 1024)."""
    if rows <= 0 or n <= 0 or rows > n or sms <= 0:
        raise ValueError(f"precond_plan: rows={rows}, n={n}, sms={sms}")
    target = PRECOND_BLOCKS_PER_SM * sms
    row_warps = -(-rows // PRECOND_ROWS)
    warps = PRECOND_WARPS
    while warps > 1 and -(-row_warps // warps) < target:
        warps //= 2
    step = PRECOND_WARPS * PRECOND_ROWS
    steps, bands = -(-rows // step), -(-n // PRECOND_BAND)
    # about half of a square's (band, chunk) blocks lie above the triangle
    want = max(-(-2 * target // bands), -(-steps * step // PRECOND_MAX_CHUNK))
    height = step * -(-steps // max(1, min(steps, want)))
    return warps, -(-rows // height), height


def _precond_geometry(lib):
    want = (PRECOND_ROWS, PRECOND_BAND, PRECOND_WARPS, PRECOND_MAX_CHUNK)
    built = tuple(lib.gpmp_precond_geometry(q) for q in range(len(want)))
    if built != want:
        raise RuntimeError(f"csrc/mixed.cu's K6 geometry (rows a warp, band, warps, chunk "
                           f"rows) is {built}, not {want}")


@capture.cached(maxsize=64)
def _precond_workspace(device, rows, n, k):
    """K6's per-(device, rows, n, k) workspace (k <= 8): the plan's warps and
    height, and raw pointers to y (rows, k), the chunks' partial sums
    (chunks, n, k), both f32, and the bands' tickets (int32, zero between
    launches: each launch resets them), beside the tensors that hold them."""
    _precond_geometry(_build.load())
    warps, chunks, height = precond_plan(rows, n, _sms_on(device))
    buf = torch.empty(rows * k + chunks * n * k, dtype=_F32, device=device)
    tickets = torch.zeros(-(-n // PRECOND_BAND), dtype=torch.int32, device=device)
    return (warps, height, buf.data_ptr(), buf.data_ptr() + 4 * rows * k, tickets.data_ptr(),
            (buf, tickets))


def precond_apply_cuda(M32, R):
    """K6 on the card: M^T (M r32) for lower-triangular f32 M and f64 or f32
    R (n, k), r32 = f32(R), f32 products and sums, the result in R's dtype.

    k <= 8: two launches from one C entry, y = M r32 by rows, then M^T y by
    column bands and row chunks, the chunks summed in order by each band's
    last block.  Wider R: two tiled triangular products from one C entry,
    y = M r32 then M^T y.  Both bitwise reproducible."""
    global K6_LAUNCHES
    dev = _check_cuda("K6 precond_apply", (M32, R), ((_F32,), (torch.float64, _F32)))
    n = _square("K6 precond_apply", M32)
    if R.ndim != 2 or R.shape[0] != n or R.shape[1] == 0:
        raise ValueError(f"K6 precond_apply: R must be ({n}, k >= 1); got {tuple(R.shape)}")
    k = R.shape[1]
    lib = _build.load()
    out = torch.empty((n, k), dtype=R.dtype, device=dev)
    f64 = R.dtype == torch.float64
    if k <= MATVEC_MAX_COLS:
        warps, height, y, part, tickets, _ = _precond_workspace(dev, n, n, k)
        fn = lib.gpmp_precond_apply_f64 if f64 else lib.gpmp_precond_apply_f32
        _build.launch("K6 precond_apply", fn, dev, M32.data_ptr(), R.data_ptr(), y, part,
                      tickets, out.data_ptr(), n, k, warps, height)
    else:
        y = torch.empty((n, k), dtype=_F32, device=dev)
        fn = lib.gpmp_precond_apply_wide_f64 if f64 else lib.gpmp_precond_apply_wide_f32
        _build.launch("K6 precond_apply (wide)", fn, dev, M32.data_ptr(),
                      R.data_ptr(), y.data_ptr(), out.data_ptr(), n, k)
    K6_LAUNCHES += 1
    return out


def precond_apply_slab_cuda(M32, R, off):
    """K6 on the card, slab form: this rank's part of M^T (M r32), f32 (n, k),
    from its (rows, n) row slab of M (global rows [off, off + rows)) and all
    of r (n, k <= 8); the square form's two launches."""
    global K6_LAUNCHES
    dev = _check_cuda("K6 precond_apply_slab", (M32, R), ((_F32,), (torch.float64, _F32)))
    rows, n = M32.shape
    if not (0 <= off and off + rows <= n) or R.ndim != 2 or R.shape[0] != n:
        raise ValueError(f"K6 precond_apply_slab: M rows [{off}, {off + rows}) of n={n}, R "
                         f"({n}, k); got {tuple(M32.shape)}, {tuple(R.shape)}")
    k = R.shape[1]
    if not 1 <= k <= MATVEC_MAX_COLS:
        raise ValueError(f"K6 precond_apply_slab takes 1..{MATVEC_MAX_COLS} columns; got {k}")
    lib = _build.load()
    warps, height, y, part, tickets, _ = _precond_workspace(dev, rows, n, k)
    out = torch.empty((n, k), dtype=_F32, device=dev)
    fn = (lib.gpmp_precond_apply_slab_f64 if R.dtype == torch.float64
          else lib.gpmp_precond_apply_slab_f32)
    _build.launch("K6 precond_apply_slab", fn, dev, M32.data_ptr(), R.data_ptr(), y, part,
                  tickets, out.data_ptr(), rows, n, int(off), k, warps, height)
    K6_LAUNCHES += 1
    return out


# K4 and K4s's launch geometry (csrc/residual.cu): square output tiles of
# RESIDUAL_TILE, 4 warps each, two blocks to an SM (measured on the card
# against K9u's 128-wide tiles of 8 warps, and against a split k range at
# n = 1000: no slower at any n, 2.5-2.7x faster below 2048; PERF.md)
RESIDUAL_TILE = 64


def _residual_tile(lib):
    if lib.gpmp_residual_tile() != RESIDUAL_TILE:
        raise RuntimeError(f"csrc/residual.cu's tile is {lib.gpmp_residual_tile()}, "
                           f"not RESIDUAL_TILE = {RESIDUAL_TILE}")
    return RESIDUAL_TILE


def _longest_first(i0, j0, kend):
    """The (i0, j0) corners as an int32 (count, 2) tensor, the longest k
    range first (row order among equals): the longest tiles start in the
    first wave, so none is left to run alone at the end."""
    order = torch.sort(-kend, stable=True).indices
    return torch.stack([i0[order], j0[order]], 1).to(torch.int32)


def residual_tiles(n, tile):
    """K4's launch geometry: the corners (i0, j0), j0 <= i0, of the
    tile-square output tiles of the (n, n) lower triangle (one thread block
    each; the kernel masks the diagonal tiles entrywise), on the CPU.  L is
    lower triangular, so a tile sums over k < min(j0 + tile, n); listed
    longest first."""
    if n <= 0 or tile <= 0:
        raise ValueError(f"residual_tiles: n={n}, tile={tile}")
    i0, j0 = torch.meshgrid(torch.arange(0, n, tile), torch.arange(0, n, tile), indexing="ij")
    keep = j0 <= i0
    i0, j0 = i0[keep], j0[keep]
    return _longest_first(i0, j0, torch.clamp(j0 + tile, max=n))


def residual_slab_tiles(rows, rows_b, off, offs, tile):
    """K4s's launch geometry: the global corners (i0, j0) of the tiles of one
    (rows, rows_b) column block, rows [off, off + rows) by columns
    [offs, offs + rows_b), both triangles; a tile sums over k up to the
    smaller of its last row and last column.  Longest first, on the CPU."""
    if rows <= 0 or rows_b <= 0 or off < 0 or offs < 0 or tile <= 0:
        raise ValueError(f"residual_slab_tiles: rows={rows}, rows_b={rows_b}, off={off}, "
                         f"offs={offs}, tile={tile}")
    i0, j0 = torch.meshgrid(torch.arange(off, off + rows, tile),
                            torch.arange(offs, offs + rows_b, tile), indexing="ij")
    i0, j0 = i0.reshape(-1), j0.reshape(-1)
    ilast = torch.clamp(i0 + tile, max=off + rows) - 1
    jlast = torch.clamp(j0 + tile, max=offs + rows_b) - 1
    return _longest_first(i0, j0, torch.minimum(ilast, jlast) + 1)


def residual_panel_tiles(n, c0, w, tile):
    """K10r's panel geometry (recompute mode): the global corners (i0, j0)
    of the tile-square tiles of rows [c0, n) by columns [c0, c0 + w), on a
    grid measured from c0, that meet i >= j (i0 >= j0; the kernel masks the
    diagonal tiles entrywise).  A tile sums over k up to the smaller of its
    last row and last column.  c0 and w need not be multiples of tile.
    Longest first, on the CPU."""
    if n <= 0 or c0 < 0 or w <= 0 or c0 + w > n or tile <= 0:
        raise ValueError(f"residual_panel_tiles: n={n}, c0={c0}, w={w}, tile={tile}")
    i0, j0 = torch.meshgrid(torch.arange(c0, n, tile), torch.arange(c0, c0 + w, tile),
                            indexing="ij")
    keep = j0 <= i0
    i0, j0 = i0[keep], j0[keep]
    jlast = torch.clamp(j0 + tile, max=c0 + w) - 1
    return _longest_first(i0, j0, torch.minimum(torch.clamp(i0 + tile, max=n) - 1, jlast) + 1)


@capture.cached(maxsize=64)
def _residual_tiles_on(device, n, tile):
    return residual_tiles(n, tile).to(device)


@capture.cached(maxsize=64)
def _residual_slab_tiles_on(device, rows, rows_b, off, offs, tile):
    return residual_slab_tiles(rows, rows_b, off, offs, tile).to(device)


# one entry per panel of the recompute mode's pass (100 at n = 51200)
@capture.cached(maxsize=256)
def _residual_panel_tiles_on(device, n, c0, w, tile):
    return residual_panel_tiles(n, c0, w, tile).to(device)


def factorization_residual_slab_cuda(K, La, Lb, off, offs, R):
    """K4s on the card: R[:, offs:offs + rows_b] = f32(K[:, offs:offs +
    rows_b] - La Lb^T) in f64, K and R (rows, n) (global rows [off, off +
    rows)), La this slab's rows of the lower-triangular f32 L, Lb a source
    slab's (global rows [offs, offs + rows_b)); returns R."""
    global K4S_LAUNCHES
    dev = _check_cuda("K4s factorization_residual_slab", (K, La, Lb, R),
                      ((torch.float64,), (_F32,), (_F32,), (_F32,)))
    rows, n = K.shape
    rows_b = Lb.shape[0]
    if La.shape != K.shape or R.shape != K.shape or Lb.shape[1] != n:
        raise ValueError(f"K4s: K, La and R must be {tuple(K.shape)} and Lb (rows_b, {n}); "
                         f"got {tuple(La.shape)}, {tuple(R.shape)}, {tuple(Lb.shape)}")
    off, offs = int(off), int(offs)
    if not (0 <= off and off + rows <= n and 0 <= offs and offs + rows_b <= n):
        raise ValueError(f"K4s: rows [{off}, {off + rows}) or [{offs}, {offs + rows_b}) "
                         f"outside n={n}")
    lib = _build.load()
    tiles = _residual_slab_tiles_on(dev, rows, rows_b, off, offs, _residual_tile(lib))
    _build.launch("K4s factorization_residual_slab", lib.gpmp_slab_fact_residual_mma, dev,
                  K.data_ptr(), La.data_ptr(), Lb.data_ptr(), R.data_ptr(), tiles.data_ptr(),
                  tiles.shape[0], rows, rows_b, n, off, offs)
    K4S_LAUNCHES += 1
    return R


def factorization_residual_cuda(K, L32):
    """K4 on the card: symmetric f32 K - L L^T from the lower triangle."""
    global K4_LAUNCHES
    dev = _check_cuda("K4 factorization_residual", (K, L32),
                      ((torch.float64, torch.float32), (_F32,)))
    n = _square("K4 factorization_residual", K)
    if L32.shape != K.shape:
        raise ValueError(f"K4: L must be {tuple(K.shape)}; got {tuple(L32.shape)}")
    lib = _build.load()
    tile = _residual_tile(lib)
    tiles = _residual_tiles_on(dev, n, tile)
    out = torch.empty((n, n), dtype=_F32, device=dev)
    fn = (lib.gpmp_fact_residual_mma_f64 if K.dtype == torch.float64
          else lib.gpmp_fact_residual_mma_f32)
    _build.launch("K4 factorization_residual", fn, dev, K.data_ptr(), L32.data_ptr(),
                  out.data_ptr(), tiles.data_ptr(), tiles.shape[0], n)
    K4_LAUNCHES += 1
    return out


def diag_block_inv_cuda(L32, base):
    """K5 on the card: (ceil(n / base), base, base) diagonal-block inverses,
    one thread block per diagonal block, in its shared memory: the leaves by
    substitution, then the doubling levels (diag_block_inv_plain's order)."""
    global K5_LAUNCHES
    dev = _check_cuda("K5 diag_block_inv", (L32,), ((_F32,),))
    n = _square("K5 diag_block_inv", L32)
    lib = _build.load()
    if not 1 <= base <= lib.gpmp_diag_block_inv_max_base():
        raise ValueError(f"K5: base {base} outside 1..{lib.gpmp_diag_block_inv_max_base()}")
    out = torch.empty((-(-n // base), base, base), dtype=_F32, device=dev)
    _build.launch("K5 diag_block_inv", lib.gpmp_diag_block_inv, dev, L32.data_ptr(),
                  out.data_ptr(), n, base)
    K5_LAUNCHES += 1
    return out


# K7's launch geometry (csrc/mixed.cu): blocks of TRACE_SUMS_THREADS threads
# in a flat grid-stride pass over the 16-byte groups (4 entries) of a (rows,
# n) H, TRACE_SUMS_UNROLL groups a thread step; enough blocks for one step a
# thread, at most TRACE_SUMS_BLOCKS_PER_SM an SM
TRACE_SUMS_THREADS, TRACE_SUMS_UNROLL, TRACE_SUMS_BLOCKS_PER_SM = 256, 4, 4


def trace_sums_plan(rows, n, sms):
    """K7's grid for a (rows, n) H or row slab, on the CPU: the number of
    blocks; thread j of the grid takes the groups j, j + S, j + 2 S, ... (S
    the grid's threads), group g the entries 4 g .. 4 g + 3 of the flat slab
    (n = 1000 on the H100's 132 SMs: 245 blocks; n = 8192: 528)."""
    if rows <= 0 or n <= 0 or sms <= 0:
        raise ValueError(f"trace_sums_plan: rows={rows}, n={n}, sms={sms}")
    groups = -(-rows * n // 4)
    per_block = TRACE_SUMS_THREADS * TRACE_SUMS_UNROLL
    return max(1, min(-(-groups // per_block), TRACE_SUMS_BLOCKS_PER_SM * sms))


@capture.cached(maxsize=64)
def _trace_sums_workspace(device, rows, n):
    """K7's per-(device, rows, n) workspace, shared by trace_sums and
    series_sums: the plan's blocks, and raw pointers to the blocks' partial
    pairs (f64) and to the ticket (int32, zero between launches: each launch
    resets it), beside the tensors that hold them."""
    lib = _build.load()
    want = (TRACE_SUMS_THREADS, TRACE_SUMS_UNROLL)
    built = (lib.gpmp_trace_sums_geometry(0), lib.gpmp_trace_sums_geometry(1))
    if built != want:
        raise RuntimeError(f"csrc/mixed.cu's K7 geometry (threads, groups a step) is {built}, "
                           f"not {want}")
    blocks = trace_sums_plan(rows, n, _sms_on(device))
    part = torch.empty(2 * blocks, dtype=torch.float64, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    return blocks, part.data_ptr(), ticket.data_ptr(), (part, ticket)


def _trace_sums_launch(name, H, H2, off):
    global K7_LAUNCHES
    dev = H.device
    rows, n = H.shape
    blocks, part, ticket, _ = _trace_sums_workspace(dev, rows, n)
    out = torch.empty(2, dtype=torch.float64, device=dev)
    _build.launch(name, _build.load().gpmp_trace_sums, dev, H.data_ptr(),
                  None if H2 is None else H2.data_ptr(), part, ticket, out.data_ptr(), rows, n,
                  off, blocks)
    K7_LAUNCHES += 1
    return out


def trace_sums_cuda(H, off=0):
    """K7 on the card: [tr H, sum H^2] in f64; on a (rows, n) row slab of
    global rows [off, off + rows), its part of both.  One launch, finished
    by its last block (bitwise reproducible)."""
    _check_cuda("K7 trace_sums", (H,), ((_F32,),))
    _slab_shape("K7 trace_sums", H, off)
    return _trace_sums_launch("K7 trace_sums", H, None, int(off))


def series_sums_cuda(H, H2):
    """K7 on the card: [sum H^2 o H, sum (H^2)^2] in f64 (over a row slab:
    its part).  One launch, as trace_sums_cuda."""
    _check_cuda("K7 series_sums", (H, H2), ((_F32,), (_F32,)))
    _slab_shape("K7 series_sums", H, 0)
    if H2.shape != H.shape:
        raise ValueError(f"K7: H2 must be {tuple(H.shape)}; got {tuple(H2.shape)}")
    return _trace_sums_launch("K7 series_sums", H, H2, 0)


def _slab_shape(name, H, off):
    if H.ndim != 2 or H.shape[0] == 0 or not (0 <= off and off + H.shape[0] <= H.shape[1]):
        raise ValueError(f"{name}: expected the rows [{off}, {off} + rows) of an (n, n) "
                         f"matrix, got {tuple(H.shape)}")
    return H.shape


def _loo_diag_launch(name, fn, dev, A, B):
    global K7B_LAUNCHES
    n = A.shape[0]
    lib = _build.load()
    partial = torch.empty((lib.gpmp_loo_diag_chunks(n), n), dtype=torch.float64, device=dev)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    _build.launch(name, fn, dev, A.data_ptr(), B.data_ptr(), partial.data_ptr(),
                  out.data_ptr(), n)
    K7B_LAUNCHES += 1
    return out


def loo_diag_series_cuda(M32, B32, dtype):
    """K7b on the card, series branch: sum_i M_ij^2 - sum_i M_ij B_ij, the
    products and sums in f64, M read once for both; cast to ``dtype``."""
    dev = _check_cuda("K7b loo_diag_series", (M32, B32), ((_F32,), (_F32,)))
    n = _square("K7b loo_diag_series", M32)
    if B32.shape != M32.shape:
        raise ValueError(f"K7b: B must be {tuple(M32.shape)}; got {tuple(B32.shape)}")
    lib = _build.load()
    return _loo_diag_launch("K7b loo_diag_series", lib.gpmp_loo_diag_series, dev, M32,
                            B32).to(dtype)


def loo_diag_pairs_cuda(G, W):
    """K7b on the card, two-level branch: sum_i G_ij W_ij in f64, cast to G's dtype."""
    fp = (torch.float64, torch.float32)
    dev = _check_cuda("K7b loo_diag_pairs", (G, W), (fp, (G.dtype,)))
    n = _square("K7b loo_diag_pairs", G)
    if W.shape != G.shape:
        raise ValueError(f"K7b: W must be {tuple(G.shape)}; got {tuple(W.shape)}")
    lib = _build.load()
    fn = lib.gpmp_loo_diag_pairs_f64 if G.dtype == torch.float64 else lib.gpmp_loo_diag_pairs_f32
    return _loo_diag_launch("K7b loo_diag_pairs", fn, dev, G, W).to(G.dtype)


# ----------------------------------------------------------------------------
# Dispatch on the tensors' device
# ----------------------------------------------------------------------------
def _on_card(t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def residual(K, X, B):
    """(R = B - K X, [sum R^2, sum B^2] in f64) for (n, k) X and B.

    k <= 8: K3 (card) or its plain version (CPU).  Wider X: torch.matmul,
    as the JAX package's ``_f64_matvec`` takes ``jnp.dot`` there."""
    if X.shape[1] > MATVEC_MAX_COLS:
        R = B - K @ X
        return R, torch.stack([torch.sum(R * R), torch.sum(B * B)]).double()
    if _on_card(K):
        return residual_cuda(K.contiguous(), X.contiguous(), B.contiguous())
    return residual_plain(K, X, B)


def factorization_residual(K, L32):
    if _on_card(K):
        return factorization_residual_cuda(K.contiguous(), L32.contiguous())
    return factorization_residual_plain(K, L32)


def precond_apply_slab(M32, R, off):
    if _on_card(M32):
        return precond_apply_slab_cuda(M32.contiguous(), R.contiguous(), off)
    return precond_apply_slab_plain(M32, R)


def factorization_residual_slab(K, La, Lb, off, offs, R):
    if _on_card(K):
        return factorization_residual_slab_cuda(K.contiguous(), La.contiguous(),
                                                Lb.contiguous(), off, offs, R)
    return factorization_residual_slab_plain(K, La, Lb, offs, R)


def diag_block_inv(L32, base):
    if _on_card(L32):
        return diag_block_inv_cuda(L32.contiguous(), base)
    return diag_block_inv_plain(L32, base)


def trace_sums(H, off=0):
    if _on_card(H):
        return trace_sums_cuda(H.contiguous(), off)
    return trace_sums_plain(H, off)


def series_sums(H, H2):
    if _on_card(H):
        return series_sums_cuda(H.contiguous(), H2.contiguous())
    return series_sums_plain(H, H2)


def loo_diag_series(M32, B32, dtype):
    if _on_card(M32):
        return loo_diag_series_cuda(M32.contiguous(), B32.contiguous(), dtype)
    return loo_diag_series_plain(M32, B32, dtype)


def loo_diag_pairs(G, W):
    if _on_card(G):
        return loo_diag_pairs_cuda(G.contiguous(), W.contiguous())
    return loo_diag_pairs_plain(G, W)


# ----------------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------------
def _block_tri_inv(L32, base=TRI_INV_BASE, blocks=None):
    """Inverse of a lower-triangular f32 matrix by recursive 2x2 blocking.

    [[A, 0], [C, B]]^{-1} = [[A^{-1}, 0], [-B^{-1} C A^{-1}, B^{-1}]]:
    the diagonal-block inverses (K5), then log2(nb) levels of batched
    products, for n = base * 2^k.  Any other n is split unevenly at the
    largest base * 2^k below it, as in the JAX package: A^{-1} and B^{-1}
    recurse, X = -B^{-1} C A^{-1} is two products.  (Padding n with the
    identity instead would hold (n_pad / n)^2 times the memory: two 16 GiB
    temporaries at n = 51200.)  Every split falls on a multiple of base, so
    one K5 launch inverts all the diagonal blocks first (``blocks``, the
    ragged last one identity-completed) and the recursion only multiplies.
    Exact zeros above the diagonal by construction."""
    n0 = L32.shape[0]
    if n0 <= base:
        return diag_block_inv(L32, n0)[0] if blocks is None else blocks[0][:n0, :n0]
    if blocks is None:
        blocks = diag_block_inv(L32, base)
    k = math.ceil(math.log2(-(-n0 // base)))
    if base << k != n0:
        n1 = base << (k - 1)
        out = torch.zeros((n0, n0), dtype=L32.dtype, device=L32.device)
        Ai = out[:n1, :n1]
        Ai.copy_(_block_tri_inv(L32[:n1, :n1], base, blocks[:n1 // base]))
        Bi = _block_tri_inv(L32[n1:, n1:], base, blocks[n1 // base:])
        out[n1:, :n1] = -(Bi @ (L32[n1:, :n1] @ Ai))
        out[n1:, n1:] = Bi
        return out
    s = base
    Bk = blocks
    for _ in range(k):
        m = Bk.shape[0] // 2  # pairs at this level
        A_blk, B_blk = Bk[0::2], Bk[1::2]
        jdx = torch.arange(m, device=L32.device)
        C = L32.reshape(m, 2, s, m, 2, s)[jdx, 1, :, jdx, 0, :]  # (m, s, s)
        X = -torch.matmul(B_blk, torch.matmul(C, A_blk))
        top = torch.cat([A_blk, torch.zeros_like(A_blk)], dim=2)
        bot = torch.cat([X, B_blk], dim=2)
        Bk = torch.cat([top, bot], dim=1)  # (m, 2s, 2s)
        s *= 2
    return Bk[0]


def _f32_preconditioner(K):
    """(L32, M32 = L32^{-1}), both f32; NaN where K + ridge is not PD."""
    n = K.shape[0]
    K32 = K.to(_F32, copy=True)
    ridge = _RIDGE_FACTOR * torch.finfo(_F32).eps * (torch.trace(K32) / n)
    K32.diagonal().add_(ridge)
    L32, info = torch.linalg.cholesky_ex(K32)
    # row-major: cuSOLVER hands back a column-major factor
    L32 = torch.where(info == 0, L32, torch.nan).contiguous()
    return L32, _block_tri_inv(L32)


def _apply(M32, R):
    """Preconditioner application M^T (M r32) cast to R's dtype, r32 =
    f32(R), for (n, k) R of any width: K6 (card) or its plain version (CPU)."""
    if _on_card(M32):
        return precond_apply_cuda(M32.contiguous(), R.contiguous())
    return precond_apply_plain(M32, R)


def _rel2(norms, dtype):
    """sum R^2 / max(sum B^2, tiny), read from the device (one sync)."""
    rr, bb = norms.tolist()
    return rr / max(bb, torch.finfo(dtype).tiny)


def refined_cholesky_solve(K, B, precond=None, n_refine=DEFAULT_REFINE_ITERS,
                           early_exit=False):
    """Solve K X = B to ~f64 accuracy via f32-preconditioned refinement.

    Returns (X, (L32, M32)); the preconditioner can be passed back in to
    reuse it for another solve with the same K.  early_exit=True stops the
    sweeps when the residual reaches its floor or stagnates, as the JAX
    package's while_loop does (r2 >= 1e-24, r2 < r2_prev / 4, it <
    n_refine); otherwise n_refine sweeps run.  A final relative residual
    with rel^2 >= 1e-12 turns X into NaN."""
    if precond is None:
        precond = _f32_preconditioner(K)
    _L32, M32 = precond
    squeeze = B.ndim == 1
    Bm = B.reshape(-1, 1) if squeeze else B
    X = _apply(M32, Bm)
    R, norms = residual(K, X, Bm)
    if early_exit:
        r2, r2_prev, it = _rel2(norms, K.dtype), math.inf, 0
        while r2 >= _REFINE_FLOOR2 and r2 < 0.25 * r2_prev and it < n_refine:
            X = X + _apply(M32, R)
            R, norms = residual(K, X, Bm)
            r2_prev, r2 = r2, _rel2(norms, K.dtype)
            it += 1
    else:
        for _ in range(n_refine):
            X = X + _apply(M32, R)
            R, norms = residual(K, X, Bm)
        r2 = _rel2(norms, K.dtype)
    if not r2 < _SOLVE_RTOL2:  # NaN compares False: a failed solve is NaN
        X = torch.full_like(X, torch.nan)
    return (X.reshape(-1) if squeeze else X), precond


def _second_level(E):
    """(M_E, D) from a second f32 factorization of the near-identity E:
    M_E = chol_f32(E)^{-1} promoted to E's dtype, D = M_E E M_E^T - I."""
    _L_E, M_E32 = _f32_preconditioner(E)
    M_E = M_E32.to(E.dtype)
    return M_E, M_E @ E @ M_E.T - torch.eye(E.shape[0], dtype=E.dtype, device=E.device)


def _kinv_two_level(E, M):
    """(G, W, D) with K^{-1} ~= G^T W, G = M_E M, W = (I - D + D^2) G, for
    E = M K M^T (or I + H) and D from its second level."""
    M_E, D = _second_level(E)
    G = M_E @ M
    eye = torch.eye(E.shape[0], dtype=E.dtype, device=E.device)
    return G, (eye - D + D @ D) @ G, D


def _logdet_two_level(ld_L, H, dtype):
    """log det K = ld_L + log det(I + H) from a second f32 factorization of
    I + H; NaN unless |E2 - I|_F^2 < 1e-8."""
    E = torch.eye(H.shape[0], dtype=dtype, device=H.device) + H.to(dtype)
    M_E, D2 = _second_level(E)
    d2norm2 = torch.sum(D2 * D2)
    corr2 = torch.trace(D2) - 0.5 * d2norm2
    ld = ld_L - 2.0 * torch.sum(torch.log(torch.diagonal(M_E))) + corr2
    return torch.where(d2norm2 < _LOGDET_FTOL2, ld, torch.nan)


def _mp_solve_and_logdet_core(n_refine, K, B):
    """(X, log det K, (M32, H, series)).

    H = M (K - L L^T) M^T in f32 from the f64 factorization residual (K4).
    tr H^2 (K7, one read) chooses the branch on the host: the quartic
    trace series when tr H^2 < 1e-4, else the two-level factorization.  A
    NaN tr H^2 (non-PD K) takes the two-level branch and gives NaN."""
    X, (L32, M32) = refined_cholesky_solve(K, B, n_refine=n_refine, early_exit=True)
    H = M32 @ (factorization_residual(K, L32) @ M32.T)
    sums = trace_sums(H)
    series = float(sums[1]) < _SERIES_TAU
    ld_L = 2.0 * torch.sum(torch.log(torch.diagonal(L32).to(K.dtype)))
    if series:
        s3, s4 = series_sums(H, H @ H).to(K.dtype)
        tr, tr2 = sums.to(K.dtype)
        ld = ld_L + tr - tr2 / 2.0 + s3 / 3.0 - s4 / 4.0
    else:
        ld = _logdet_two_level(ld_L, H, K.dtype)
    return X, ld, (M32, H, series)


def _mp_kinv(M32, H, series, dtype):
    """K^{-1} from the saved preconditioner and defect H, on the branch the
    logdet took: M^T (I - H + H^2) M (series), or its two-level analogue."""
    M = M32.to(dtype)
    if series:
        # the identity part in f64; the O(|H|) correction in f32
        return M.T @ M - (M32.T @ ((H - H @ H) @ M32)).to(dtype)
    eye = torch.eye(M.shape[0], dtype=dtype, device=M.device)
    G, W, _D = _kinv_two_level(eye + H.to(dtype), M)
    return G.T @ W


def _as_matrix(T):
    return T.reshape(-1, 1) if T.ndim == 1 else T


class _MpSolveAndLogdet(torch.autograd.Function):
    """(K^{-1} B, log det K) with the analytic backward of the JAX
    package's ``_mp_sal_bwd``."""

    @staticmethod
    def forward(ctx, K, B, n_refine):
        X, ld, (M32, H, series) = _mp_solve_and_logdet_core(n_refine, K, B)
        ctx.save_for_backward(K, M32, H, X)
        ctx.series, ctx.n_refine = series, n_refine
        return X, ld

    @staticmethod
    @first_order_only("mp_solve_and_logdet")
    def backward(ctx, Xbar, ldbar):
        K, M32, H, X = ctx.saved_tensors
        S, _ = refined_cholesky_solve(K, _as_matrix(Xbar), precond=(None, M32),
                                      n_refine=ctx.n_refine, early_exit=True)
        Kbar = None
        if ctx.needs_input_grad[0]:
            Kbar = ldbar * _mp_kinv(M32, H, ctx.series, K.dtype) - S @ _as_matrix(X).T
        return Kbar, S.reshape(Xbar.shape), None


def mp_solve_and_logdet(K, B, n_refine=DEFAULT_REFINE_ITERS):
    """(K^{-1} B, log det K) sharing one f32 preconditioner; differentiable
    (reverse mode) through an analytic backward."""
    return _MpSolveAndLogdet.apply(K, B, n_refine)


class _RefinedSolve(torch.autograd.Function):
    """K^{-1} B with Kbar = -S X^T, Bbar = S = K^{-1} Xbar: reverse mode
    never differentiates the preconditioner's construction."""

    @staticmethod
    def forward(ctx, K, B, n_refine):
        X, (_L32, M32) = refined_cholesky_solve(K, B, n_refine=n_refine, early_exit=True)
        ctx.save_for_backward(K, M32, X)
        ctx.n_refine = n_refine
        return X

    @staticmethod
    @first_order_only("refined_solve")
    def backward(ctx, Xbar):
        K, M32, X = ctx.saved_tensors
        S, _ = refined_cholesky_solve(K, _as_matrix(Xbar), precond=(None, M32),
                                      n_refine=ctx.n_refine, early_exit=True)
        Kbar = -S @ _as_matrix(X).T if ctx.needs_input_grad[0] else None
        return Kbar, S.reshape(Xbar.shape), None


def refined_solve(K, B, n_refine=DEFAULT_REFINE_ITERS):
    """K^{-1} B via the f32-preconditioned refined solve, differentiable."""
    return _RefinedSolve.apply(K, B, n_refine)


def _inv_diag(K, M32):
    """diag(K^{-1}) from the series K^{-1} ~= M^T (I - D + D^2) M with
    D = M K M^T - I (two f64 products, since each diagonal entry is
    consumed on its own), the correction in f32 (K7b, series);
    |D|_F^2 >= 1e-4 takes the two-level expansion (K7b, pairs), NaN unless
    its |E2 - I|_F^2 < 1e-8."""
    n = K.shape[0]
    M = M32.to(K.dtype)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    D = M @ (K @ M.T) - eye
    if float(torch.sum(D * D)) < _SERIES_TAU:
        D32 = D.to(_F32)
        return loo_diag_series(M32, (D32 - D32 @ D32) @ M32, K.dtype)
    G, W, DL = _kinv_two_level(D + eye, M)
    d = loo_diag_pairs(G, W)
    return torch.where(torch.sum(DL * DL) < _LOGDET_FTOL2, d, torch.nan)


class _MpSolveAndInvDiag(torch.autograd.Function):
    """(K^{-1} B, diag K^{-1}) with the analytic backward
    Kbar = -K^{-1} diag(dbar) K^{-1} - S X^T, Bbar = S, S = K^{-1} Xbar: one
    refined solve of K [S, K^{-1}] = [Xbar, I] on the saved preconditioner.
    (The JAX package differentiates its own unrolled sweeps and f32 series
    instead; both tend to the exact gradient.)"""

    @staticmethod
    def forward(ctx, K, B, n_refine):
        X, (_L32, M32) = refined_cholesky_solve(K, B, n_refine=n_refine)
        ctx.save_for_backward(K, M32, X)
        ctx.n_refine = n_refine
        return X, _inv_diag(K, M32)

    @staticmethod
    @first_order_only("mp_solve_and_inv_diag")
    def backward(ctx, Xbar, dbar):
        K, M32, X = ctx.saved_tensors
        Xb = _as_matrix(Xbar)
        k = Xb.shape[1]
        eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        Y, _ = refined_cholesky_solve(K, torch.cat([Xb, eye], dim=1), precond=(None, M32),
                                      n_refine=ctx.n_refine, early_exit=True)
        S, Kinv = Y[:, :k], Y[:, k:]
        Kbar = None
        if ctx.needs_input_grad[0]:
            Kbar = -(Kinv * dbar) @ Kinv - S @ _as_matrix(X).T
        return Kbar, S.reshape(Xbar.shape), None


def mp_solve_and_inv_diag(K, B, n_refine=DEFAULT_REFINE_ITERS):
    """(K^{-1} B to ~f64, diag(K^{-1}) to ~1e-7 relative): the LOO block.

    n_refine sweeps without early exit; diag(K^{-1}) from the trace series
    (``_inv_diag``).  A non-PD K gives NaN.  Differentiable (reverse mode)
    through an analytic backward."""
    return _MpSolveAndInvDiag.apply(K, B, n_refine)
