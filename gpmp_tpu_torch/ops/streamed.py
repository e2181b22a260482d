# gpmp_tpu_torch/ops/streamed.py
"""The kernels of the streamed large-n engine (gpmp_tpu_torch/parallel/
streamed.py): K10b, K10r, K10m and K10t, their plain versions and counters.

Counterpart of the device programs of gpmp_tpu/parallel/streamed.py:

- K10b ``split_rows`` (``_build_ff``, ``_build_k32``, the diagonal term of
  ``_gram_rows``): an f64 row chunk (c, n) of the cross-covariance, plus
  ``corr`` on the global diagonal, written in place into rows [r0, r0 + c)
  of the (n, n) f32 pair (hi = f32(v), lo = f32(v - hi)), or of K32 alone
  with an f32 ridge on the diagonal (csrc/streamed.cu).
- K10r ``streamed_residual_ff`` / ``residual_panel``
  (``_streamed_residual_f32``): R = K - L32 L32^T in f64, f32 and exactly
  symmetric, with K read from the pair (one launch over K4's tiles) or from
  an f64 column panel (n - c0, width) at (c0, c0) (one launch per panel,
  over ``mixed.residual_panel_tiles``): K4's tensor-core kernel on these
  sources (csrc/residual.cu), bitwise K4 on hi + lo.
- K10m ``ff_residual`` (``_matvec_ff`` and the residual of
  ``_refined_solve_streamed``): R = B - (K32 + E32) X in f64 and
  (sum R^2, sum B^2), for k <= 8 columns: a bandwidth-bound kernel on the
  pair, 4 rows a warp, 16-byte loads (csrc/mixed.cu).
- K10t ``h_traces_chunk`` (``_h_traces``): for the row chunk r0 .. r0 + c of
  H and H2r = H[r0:r0+c] @ H, adds (tr H, sum Hr o Hc^T, sum H2r o Hc^T,
  sum H2r^2) of the chunk to an f64 accumulator: one bandwidth-bound
  launch a chunk over the tiles of ``h_traces_plan`` (csrc/streamed.cu).

Each dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); there is no fallback between them.
The plain versions keep the JAX package's arithmetic and bound their
temporaries the same way (column panels, row chunks), so that they also
serve as the kernels' oracle on the card at n = 32768.  ``*_LAUNCHES``
count kernel launches; the plain versions count nothing.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .mixed import (MATVEC_MAX_COLS, _F32, _check_cuda, _on_card, _residual_panel_tiles_on,
                    _residual_tile, _residual_tiles_on, _sms_on, _square)

K10B_LAUNCHES = 0
K10R_LAUNCHES = 0
K10M_LAUNCHES = 0
K10T_LAUNCHES = 0

_F64 = torch.float64
# rows per chunk of the plain K10m (the JAX package's _matvec_ff chunk)
FF_MATVEC_CHUNK = 1024


# ----------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are held to)
# ----------------------------------------------------------------------------
def split_rows_plain(k64, corr, r0, hi, lo=None, ridge=0.0):
    """K10b plain: v = k64 + diag(corr) at rows [r0, r0 + c), then
    hi[rows] = f32(v) and lo[rows] = f32(v - hi) (ff), or, with lo None,
    hi[rows] = f32(v) plus the f32 ridge on the diagonal (in place)."""
    c, n = k64.shape
    v = k64.clone()
    idx = torch.arange(c, device=k64.device)
    v[idx, r0 + idx] += corr
    h = v.to(_F32)
    if lo is not None:
        lo[r0:r0 + c] = (v - h.to(_F64)).to(_F32)
    else:
        h[idx, r0 + idx] += torch.tensor(ridge, dtype=_F32, device=h.device)
    hi[r0:r0 + c] = h


def residual_panel_plain(P, L32, c0, R):
    """K10r plain, one column panel: from the f64 panel P = K[c0:, c0:c1],
    writes R[c0:, c0:c1] = f32(P - L[c0:, :c1] L[c0:c1, :c1]^T) (f64
    products) and its mirror R[c0:c1, c1:]; the diagonal sub-block keeps
    its lower triangle, mirrored, so that R is exactly symmetric."""
    w = P.shape[1]
    c1 = c0 + w
    Lr = L32[c0:, :c1].to(_F64)
    p = (P - Lr @ Lr[:w].T).to(_F32)
    d = torch.tril(p[:w])
    p[:w] = d + torch.tril(d, -1).T
    R[c0:, c0:c1] = p
    R[c0:c1, c1:] = p[w:].T


def streamed_residual_ff_plain(K32, E32, L32, block):
    """K10r plain, from the pair: the panel loop of the JAX package's
    _streamed_residual_f32 with column panels of ``block`` read from the
    pair (its _k64_col_slab_ff)."""
    n = K32.shape[0]
    R = torch.empty((n, n), dtype=_F32, device=K32.device)
    for c0 in range(0, n, block):
        c1 = min(n, c0 + block)
        P = K32[c0:, c0:c1].to(_F64) + E32[c0:, c0:c1].to(_F64)
        residual_panel_plain(P, L32, c0, R)
    return R


def ff_residual_plain(K32, E32, X, B, chunk=FF_MATVEC_CHUNK):
    """K10m plain: (R = B - (K32 + E32) X, [sum R^2, sum B^2]), f64; K X as
    the JAX package's _matvec_ff: per row chunk and column of X, the f32
    entries times f64 X summed in f64, hi and lo parts apart."""
    n = K32.shape[0]
    KX = torch.empty_like(X)
    for r0 in range(0, n, chunk):
        Kr, Er = K32[r0:r0 + chunk], E32[r0:r0 + chunk]
        for j in range(X.shape[1]):
            KX[r0:r0 + chunk, j] = (torch.sum(Kr * X[:, j], dim=1, dtype=_F64)
                                    + torch.sum(Er * X[:, j], dim=1, dtype=_F64))
    R = B - KX
    return R, torch.stack([torch.sum(R * R), torch.sum(B * B)])


def h_traces_chunk_plain(H, H2r, r0, acc):
    """K10t plain: acc += [tr H over the chunk, sum Hr o Hc^T,
    sum H2r o Hc^T, sum H2r^2], f64 products of f32 values (in place)."""
    c = H2r.shape[0]
    Hr = H[r0:r0 + c].to(_F64)
    HcT = H[:, r0:r0 + c].T.to(_F64)
    H2 = H2r.to(_F64)
    idx = torch.arange(c, device=H.device)
    acc += torch.stack([torch.sum(Hr[idx, r0 + idx]), torch.sum(Hr * HcT),
                        torch.sum(H2 * HcT), torch.sum(H2 * H2)])


# ----------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ----------------------------------------------------------------------------
def split_rows_cuda(k64, corr, r0, hi, lo=None, ridge=0.0):
    """K10b on the card: rows [r0, r0 + c) of hi (and lo) from the f64 chunk
    (one launch, in place)."""
    global K10B_LAUNCHES
    outs = (hi,) if lo is None else (hi, lo)
    dev = _check_cuda("K10b split_rows", (k64, corr, *outs),
                      ((_F64,), (_F64,)) + ((_F32,),) * len(outs))
    n = _square("K10b split_rows", hi)
    c = k64.shape[0]
    if k64.ndim != 2 or k64.shape[1] != n or corr.shape != (c,) or not 0 <= r0 <= n - c:
        raise ValueError(f"K10b: chunk {tuple(k64.shape)}, corr {tuple(corr.shape)}, r0 {r0} "
                         f"do not fit rows of an ({n}, {n}) buffer")
    if lo is not None and lo.shape != hi.shape:
        raise ValueError(f"K10b: lo must be {tuple(hi.shape)}; got {tuple(lo.shape)}")
    lib = _build.load()
    _build.launch("K10b split_rows", lib.gpmp_split_rows, dev, k64.data_ptr(), corr.data_ptr(),
                  hi.data_ptr(), None if lo is None else lo.data_ptr(), r0, c, n, float(ridge))
    K10B_LAUNCHES += 1


def _check_l(name, L32, n):
    if L32.shape != (n, n):
        raise ValueError(f"{name}: L must be ({n}, {n}); got {tuple(L32.shape)}")


def streamed_residual_ff_cuda(K32, E32, L32):
    """K10r on the card, from the pair: K4's tiles in one launch."""
    global K10R_LAUNCHES
    dev = _check_cuda("K10r streamed_residual_ff", (K32, E32, L32), ((_F32,),) * 3)
    n = _square("K10r streamed_residual_ff", K32)
    _check_l("K10r", E32, n)
    _check_l("K10r", L32, n)
    lib = _build.load()
    tiles = _residual_tiles_on(dev, n, _residual_tile(lib))
    R = torch.empty((n, n), dtype=_F32, device=dev)
    _build.launch("K10r streamed_residual_ff", lib.gpmp_streamed_residual_ff, dev,
                  K32.data_ptr(), E32.data_ptr(), L32.data_ptr(), R.data_ptr(),
                  tiles.data_ptr(), tiles.shape[0], n)
    K10R_LAUNCHES += 1
    return R


def residual_panel_cuda(P, L32, c0, R):
    """K10r on the card, one f64 column panel P = K[c0:, c0:c0+w] into R (in
    place: R[c0:, c0:c0+w] and its mirror)."""
    global K10R_LAUNCHES
    dev = _check_cuda("K10r residual_panel", (P, L32, R), ((_F64,), (_F32,), (_F32,)))
    n = _square("K10r residual_panel", R)
    _check_l("K10r", L32, n)
    w = P.shape[1] if P.ndim == 2 else 0
    if P.ndim != 2 or w == 0 or P.shape[0] != n - c0 or not 0 <= c0 <= n - w:
        raise ValueError(f"K10r: panel {tuple(P.shape)} at c0={c0} does not fit n={n}")
    lib = _build.load()
    tiles = _residual_panel_tiles_on(dev, n, c0, w, _residual_tile(lib))
    _build.launch("K10r residual_panel", lib.gpmp_streamed_residual_panel, dev, P.data_ptr(),
                  L32.data_ptr(), R.data_ptr(), tiles.data_ptr(), tiles.shape[0], n, c0, w)
    K10R_LAUNCHES += 1


def ff_residual_cuda(K32, E32, X, B):
    """K10m on the card: (R = B - (K32 + E32) X, [sum R^2, sum B^2]) in f64.

    Two launches from one C entry: per-block partial sums, then K3's
    fixed-order reduction (bitwise reproducible)."""
    global K10M_LAUNCHES
    dev = _check_cuda("K10m ff_residual", (K32, E32, X, B), ((_F32,), (_F32,), (_F64,), (_F64,)))
    n = _square("K10m ff_residual", K32)
    _check_l("K10m", E32, n)
    if X.ndim != 2 or X.shape != B.shape or X.shape[0] != n:
        raise ValueError(f"K10m: X, B must be ({n}, k); got {tuple(X.shape)}, {tuple(B.shape)}")
    k = X.shape[1]
    if not 1 <= k <= MATVEC_MAX_COLS:
        raise ValueError(f"K10m takes 1..{MATVEC_MAX_COLS} columns; got {k}")
    lib = _build.load()
    R = torch.empty_like(B)
    partial = torch.empty((lib.gpmp_ff_residual_blocks(n), 2), dtype=_F64, device=dev)
    norms = torch.empty(2, dtype=_F64, device=dev)
    _build.launch("K10m ff_residual", lib.gpmp_ff_residual, dev, K32.data_ptr(), E32.data_ptr(),
                  X.data_ptr(), B.data_ptr(), R.data_ptr(), partial.data_ptr(),
                  norms.data_ptr(), n, k)
    K10M_LAUNCHES += 1
    return R, norms


# K10t's launch geometry (csrc/streamed.cu): tiles of H_TRACES_ROWS chunk rows
# by H_TRACES_COLS columns, a block of H_TRACES_THREADS threads (8 warps of 4
# rows, a lane 4 columns of each) a tile at a time; a persistent grid of at
# most H_TRACES_BLOCKS_PER_SM blocks an SM
H_TRACES_ROWS, H_TRACES_COLS, H_TRACES_THREADS, H_TRACES_BLOCKS_PER_SM = 32, 128, 256, 2


def h_traces_plan(c, n, sms):
    """K10t's launch geometry for a chunk of c rows of an (n, n) H, on the
    CPU: (ta, tm, blocks) -- ta tiles over the chunk's rows and tm over the
    columns, tile t at chunk rows (t % ta) H_TRACES_ROWS and columns
    (t // ta) H_TRACES_COLS, block b walking the tiles b, b + blocks, ...
    in order (c = 512, n = 32768 on the H100's 132 SMs: 16 x 256 tiles, 264
    blocks)."""
    if c <= 0 or n <= 0 or c > n or sms <= 0:
        raise ValueError(f"h_traces_plan: c={c}, n={n}, sms={sms}")
    ta, tm = -(-c // H_TRACES_ROWS), -(-n // H_TRACES_COLS)
    return ta, tm, min(ta * tm, H_TRACES_BLOCKS_PER_SM * sms)


@functools.lru_cache(maxsize=64)
def _h_traces_workspace(device, c, n):
    """K10t's per-(device, c, n) workspace: the plan's blocks, and raw
    pointers to the blocks' partial sums (4 a block, f64) and to the ticket
    (int32, zero between launches: each launch resets it), beside the
    tensors that hold them."""
    lib = _build.load()
    want = (H_TRACES_ROWS, H_TRACES_COLS, H_TRACES_THREADS)
    built = tuple(lib.gpmp_h_traces_geometry(q) for q in range(3))
    if built != want:
        raise RuntimeError(f"csrc/streamed.cu's K10t geometry (rows, columns, threads) is "
                           f"{built}, not {want}")
    blocks = h_traces_plan(c, n, _sms_on(device))[2]
    part = torch.empty(4 * blocks, dtype=_F64, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    return blocks, part.data_ptr(), ticket.data_ptr(), (part, ticket)


def h_traces_chunk_cuda(H, H2r, r0, acc):
    """K10t on the card: adds the chunk's four sums to the f64 (4,) acc (in
    place; one launch, finished by its last block: bitwise reproducible)."""
    global K10T_LAUNCHES
    dev = _check_cuda("K10t h_traces", (H, H2r, acc), ((_F32,), (_F32,), (_F64,)))
    n = _square("K10t h_traces", H)
    c = H2r.shape[0]
    if (H2r.ndim != 2 or c == 0 or H2r.shape[1] != n or not 0 <= r0 <= n - c
            or acc.shape != (4,)):
        raise ValueError(f"K10t: H2r {tuple(H2r.shape)} at r0={r0}, acc {tuple(acc.shape)} "
                         f"do not fit n={n}")
    blocks, part, ticket, _ = _h_traces_workspace(dev, c, n)
    _build.launch("K10t h_traces", _build.load().gpmp_h_traces, dev, H.data_ptr(),
                  H2r.data_ptr(), part, ticket, acc.data_ptr(), int(r0), c, n, blocks)
    K10T_LAUNCHES += 1


# ----------------------------------------------------------------------------
# Dispatch on the tensors' device
# ----------------------------------------------------------------------------
def split_rows(k64, corr, r0, hi, lo=None, ridge=0.0):
    if _on_card(hi):
        return split_rows_cuda(k64.contiguous(), corr.contiguous(), r0, hi, lo, ridge)
    return split_rows_plain(k64, corr, r0, hi, lo, ridge)


def streamed_residual_ff(K32, E32, L32, block):
    """R from the pair: K10r in one launch (card), or the plain panel loop
    with panels of ``block`` (CPU)."""
    if _on_card(K32):
        return streamed_residual_ff_cuda(K32, E32, L32.contiguous())
    return streamed_residual_ff_plain(K32, E32, L32, block)


def residual_panel(P, L32, c0, R):
    if _on_card(P):
        return residual_panel_cuda(P.contiguous(), L32.contiguous(), c0, R)
    return residual_panel_plain(P, L32, c0, R)


def ff_residual(K32, E32, X, B):
    """(R = B - (K32 + E32) X, [sum R^2, sum B^2]): K10m on the card, one
    launch per group of at most 8 columns; the plain version on the CPU."""
    if not _on_card(K32):
        return ff_residual_plain(K32, E32, X, B)
    parts = [ff_residual_cuda(K32, E32, X[:, j:j + MATVEC_MAX_COLS].contiguous(),
                              B[:, j:j + MATVEC_MAX_COLS].contiguous())
             for j in range(0, X.shape[1], MATVEC_MAX_COLS)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([R for R, _ in parts], dim=1), sum(nr for _, nr in parts)


def h_traces_chunk(H, H2r, r0, acc):
    if _on_card(H):
        return h_traces_chunk_cuda(H, H2r.contiguous(), r0, acc)
    return h_traces_chunk_plain(H, H2r, r0, acc)
