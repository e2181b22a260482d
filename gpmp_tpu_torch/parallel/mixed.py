# gpmp_tpu_torch/parallel/mixed.py
"""Mixed-precision solve + log-determinant of the resident mesh branch, on
one card or on the ranks of a group mesh.

Counterpart of gpmp_tpu/parallel/mixed.py (single-device branch): the
dense mixed engine rebalanced for large n, with the f64 (n, n) covariance
resident and ONE f64 (n, n) product, the factorization residual:

  L32 = chol_f32(K + ridge)                  (cuSOLVER, f32)
  M32 = L32^{-1}                             (K5's recursive doubling for
                                              n >= 8192, else the blocked
                                              f32 solve with an identity
                                              right-hand side)
  R   = K - L32 L32^T                        (K4, f64 arithmetic, f32 out)
  log det K = 2 sum log diag L32 + log det(I + H),   H = M32 R M32^T

log det(I + H) by the quartic trace series (K7's sums) when tr H^2 < 1e-4,
else by a second f32 factorization of I + H with the level-2 defect
G = MF (I + H) MF^T - I summed in f64 by column blocks (the streamed
engine's ``_plain_f32_tri_pair`` and ``_streamed_level2_g``), NaN unless
rms(G) <= 1e-6 (|G|_F^2 < 1e-12 n^2, the streamed engine's
``_level2_tau``).  The JAX module's absolute gate |G|_F^2 < 1e-8 rejects
healthy evaluations at large n, as the JAX package's streamed engine
documents (gpmp_tpu/parallel/streamed.py:169-177): on an H100 at n = 16384
(bench_large_n.py's p0) a healthy second level read |G|_F^2 = 2.0e-8, and
the REML became +inf.  Solves are f32-preconditioner refinement with f64
residuals (K6, K3) and the early exit of the single-device ``while_loop``.

Backward (the JAX package's analytic VJP): Kbar = ldbar K^{-1} - S X^T,
Bbar = S = K^{-1} Xbar, with K^{-1} ~= M^T (I - H + H^2) M on the series
branch, or (MF M)^T (MF M) on the robust one.  The series branch sums the
identity part M^T M in f64, as the port's other mixed engines do, and the
robust branch W^T W (W = MF M in f32) likewise (the JAX package forms both
in f32; with cuBLAS's f32 sums that left log sigma2's gradient outside the
class envelope at n = 16384 on the streamed engine, on an H100).  The
series branch keeps Z = H - H^2 for the backward in place of H and H^2.

JAX's ``lax.cond`` and ``while_loop`` become host branches: one read of the
f32 factorization's status, one of tr H^2, one per refinement sweep.  The
JAX package's ``rblock`` panels of the residual only bounded XLA's
temporaries: K4 is one launch over the lower triangle.

On a group mesh (the JAX module's multi-device branch) K, B and X are this
rank's row slabs and every (n, n) operand a (n/R, n) slab: L32 is the
row-sharded direct f32 factor (parallel/chol.py, K9s in f32) and M32 its
blocked inverse (the blocked solve of the identity's slab); R = K - L32
L32^T by K4s, one column block per source rank, each rank's L32 slab
broadcast in turn; H = M (R M^T) and the n-wide products (H^2, the level-2
sandwich, Z M, MF M) ring over the ranks the same way, one slab at a time;
the trace sums (K7 on slabs), log det's parts and the refinement's residual
norms (K3 on slabs, X gathered) are all-reduced, so every rank takes the
same host branch; K6's slab form gives each rank's part of M^T (M r),
all-reduced.  K^{-1} of the backward is reduced and scattered by (n, n/R)
column blocks, never an (n, n) array on a rank.  The criteria's right-hand
sides have at most 8 columns (K6's slab form takes no more).
"""

from functools import partial

import torch

from gpmp_tpu_torch.ops.autograd import first_order_only
from gpmp_tpu_torch.ops import mixed as _mixed
from gpmp_tpu_torch.ops.mixed import DEFAULT_REFINE_ITERS, TRI_INV_BASE, _RIDGE_FACTOR
from . import comm
from .chol import _blocked_solve_lower_impl, _group_cholesky_, _group_solve_lower_impl
from .comm import is_group
from .streamed import (
    _cholesky_f32,
    _eye_plus,
    _level2_tau,
    _plain_f32_tri_pair,
    _refined_solve_streamed,
    _streamed_level2_g,
)

_F32 = torch.float32
_F64 = torch.float64
_SERIES_TAU = 1e-4  # tr H^2 bound of the quartic series
_LEVEL2_CHUNK = 512  # column blocks of the level-2 sandwich


def _sharded_f32_preconditioner(K, block):
    """(L32, M32 = L32^{-1}) of the ridged f32 cast of K, both f32, NaN when
    the f32 factorization fails."""
    n = K.shape[0]
    K32 = K.to(_F32, copy=True)
    K32.diagonal().add_(_RIDGE_FACTOR * torch.finfo(_F32).eps * (torch.trace(K32) / n))
    L32, info = _cholesky_f32(K32)
    del K32
    if int(info) != 0:
        L32.fill_(torch.nan)
    if n >= 8192:
        return L32, _mixed._block_tri_inv(L32, base=TRI_INV_BASE)
    eye32 = torch.eye(n, dtype=_F32, device=K.device)
    return L32, _blocked_solve_lower_impl(L32, eye32, block)


def _refined_solve(K, B, M32, n_refine):
    """K X = B by f32-preconditioned refinement with f64 residuals (K6, K3),
    early exit at the floor or on stagnation; NaN on non-convergence."""
    return _refined_solve_streamed(partial(_mixed.residual, K), B, M32, n_refine)


def _mp_core(K, B, block, n_refine):
    """(X, ld, saved) with saved = (M32, series, Z or H)."""
    n = K.shape[0]
    L32, M32 = _sharded_f32_preconditioner(K, block)
    R32 = _mixed.factorization_residual(K, L32)  # K4
    base = 2.0 * torch.sum(torch.log(torch.diagonal(L32).to(_F64)))
    del L32
    H = M32 @ (R32 @ M32.T)
    del R32
    sums = _mixed.trace_sums(H)  # K7: tr H, sum H^2
    series = float(sums[1]) < _SERIES_TAU  # NaN compares False: robust, then NaN
    if series:
        H2 = H @ H
        c3, c4 = _mixed.series_sums(H, H2)  # K7
        c1, c2 = sums
        ld = base + c1 - c2 / 2.0 + c3 / 3.0 - c4 / 4.0
        H -= H2  # Z = H - H^2, all the backward needs
        del H2
    else:
        F32, MF32 = _plain_f32_tri_pair(_eye_plus(H))
        g1, g2 = _streamed_level2_g(H, MF32, min(n, _LEVEL2_CHUNK))
        del MF32
        ld2 = base + 2.0 * torch.sum(torch.log(torch.diagonal(F32).to(_F64))) + g1 - g2 / 2.0
        ld = torch.where(g2 < _level2_tau(n), ld2, torch.nan)
    X = _refined_solve(K, B, M32, n_refine)
    return X, ld, (M32, series, H)


def _mp_kinv(M32, series, ZH):
    """K^{-1} in f64 on the branch the logdet took: M^T M - M^T Z M (the
    identity part in f64, the correction in f32), or W^T W, W = MF M (f32,
    the product summed in f64)."""
    if series:
        M = M32.to(_F64)
        Kinv = M.T @ M
        del M
        Kinv -= M32.T @ (ZH @ M32)  # promoted entrywise, no f64 temporary
        return Kinv
    _F, MF32 = _plain_f32_tri_pair(_eye_plus(ZH))
    del _F
    W = (MF32 @ M32).to(_F64)
    del MF32
    return W.T @ W


class _MpSolveAndLogdet(torch.autograd.Function):
    """(K^{-1} B, log det K) with the analytic backward of ``_mp_sal_bwd``."""

    @staticmethod
    def forward(ctx, K, B, block, n_refine):
        X, ld, (M32, series, ZH) = _mp_core(K, B, block, n_refine)
        ctx.save_for_backward(K, M32, ZH, X)
        ctx.series, ctx.n_refine = series, n_refine
        return X, ld

    @staticmethod
    @first_order_only("sharded_mp_solve_and_logdet")
    def backward(ctx, Xbar, ldbar):
        K, M32, ZH, X = ctx.saved_tensors
        Xb = Xbar.reshape(-1, 1) if Xbar.ndim == 1 else Xbar
        Xm = X.reshape(-1, 1) if X.ndim == 1 else X
        S = _refined_solve(K, Xb.contiguous(), M32, ctx.n_refine)
        Kbar = None
        if ctx.needs_input_grad[0]:
            Kbar = _mp_kinv(M32, ctx.series, ZH)
            Kbar.mul_(ldbar)
            Kbar.addmm_(S, Xm.T, alpha=-1.0)
        return Kbar, S.reshape(Xbar.shape), None, None


# ----------------------------------------------------------------------------
# the group mesh: row slabs
# ----------------------------------------------------------------------------
def _ring_bt(A, B, mesh):
    """This rank's rows of A B^T: its slab of A times every rank's slab of B
    (rank s's broadcast in turn), transposed: (n/R, n)."""
    n_loc = A.shape[0]
    out = torch.empty((n_loc, n_loc * mesh.size), dtype=torch.result_type(A, B),
                      device=A.device)
    for src in range(mesh.size):
        Bs = B if src == mesh.rank else torch.empty_like(B)
        comm.broadcast_(Bs, mesh, src=src)
        out[:, src * n_loc:(src + 1) * n_loc] = A @ Bs.T
    return out


def _ring_mm(A, C, mesh):
    """This rank's rows of A C, C row-sharded: the sum over ranks s, in rank
    order, of A's columns of s times s's slab of C (broadcast in turn)."""
    n_loc = C.shape[0]
    out = None
    for src in range(mesh.size):
        Cs = C if src == mesh.rank else torch.empty_like(C)
        comm.broadcast_(Cs, mesh, src=src)
        t = A[:, src * n_loc:(src + 1) * n_loc] @ Cs
        out = t if out is None else out.add_(t)
    return out


def _eye_slab(n_loc, n, off, dtype, device):
    eye = torch.zeros((n_loc, n), dtype=dtype, device=device)
    eye.diagonal(off).fill_(1.0)
    return eye


def _group_f32_pair(E32, mesh, block):
    """(F, F^{-1}) slabs of the ridged f32 matrix whose slab is E32 (which
    takes the ridge and becomes F in place): the row-sharded direct factor
    (NaN past a failed panel) and its blocked inverse."""
    n_loc, n = E32.shape
    off, _ = comm.rows_of(n, mesh)
    tr = comm.all_reduce_sum_(torch.sum(torch.diagonal(E32, off)).reshape(1), mesh)
    E32.diagonal(off).add_(_RIDGE_FACTOR * torch.finfo(_F32).eps * (tr[0] / n))
    F = _group_cholesky_(E32, mesh, block, "direct")
    return F, _group_solve_lower_impl(F, _eye_slab(n_loc, n, off, _F32, E32.device), block,
                                      mesh)


def _group_residual(K, L32, mesh):
    """This rank's rows of R = K - L32 L32^T, f32 (K4s per source rank)."""
    n_loc, n = K.shape
    off, _ = comm.rows_of(n, mesh)
    R = torch.empty((n_loc, n), dtype=_F32, device=K.device)
    for src in range(mesh.size):
        Ls = L32 if src == mesh.rank else torch.empty_like(L32)
        comm.broadcast_(Ls, mesh, src=src)
        _mixed.factorization_residual_slab(K, L32, Ls, off, src * n_loc, R)
    return R


def _psum_(x, mesh):
    return comm.all_reduce_sum_(x.contiguous(), mesh)


def _group_refined_solve(K, B, M32, n_refine, mesh):
    """K X = B on slabs: K6's slab form (r gathered, the ranks' parts
    all-reduced) and K3 on the slab (X gathered, the norms all-reduced)."""
    off, _ = comm.rows_of(K.shape[1], mesh)

    def apply(Rm):
        z = _mixed.precond_apply_slab(M32, comm.gather_rows(Rm.contiguous(), mesh), off)
        return comm.slab(_psum_(z, mesh), mesh).to(Rm.dtype)

    def residual(X, Bm):
        R, norms = _mixed.residual(K, comm.gather_rows(X.contiguous(), mesh), Bm)
        return R, _psum_(norms, mesh)

    return _refined_solve_streamed(residual, B, M32, n_refine, apply=apply)


def _group_mp_core(K, B, mesh, block, n_refine):
    """_mp_core on slabs: (X, ld, saved), ld replicated."""
    n_loc, n = K.shape
    off, _ = comm.rows_of(n, mesh)
    L32, M32 = _group_f32_pair(K.to(_F32, copy=True), mesh, block)
    R32 = _group_residual(K, L32, mesh)  # K4s
    base = _psum_(2.0 * torch.sum(torch.log(torch.diagonal(L32, off).to(_F64))), mesh)
    del L32
    H = _ring_mm(M32, _ring_bt(R32, M32, mesh), mesh)  # M (R M^T)
    del R32
    sums = _psum_(_mixed.trace_sums(H, off), mesh)  # K7: tr H, sum H^2
    series = float(sums[1]) < _SERIES_TAU  # replicated: every rank takes this branch
    if series:
        H2 = _ring_mm(H, H, mesh)
        c3, c4 = _psum_(_mixed.series_sums(H, H2), mesh)  # K7
        c1, c2 = sums
        ld = base + c1 - c2 / 2.0 + c3 / 3.0 - c4 / 4.0
        H -= H2  # Z = H - H^2
        del H2
    else:
        E = H.clone()
        E.diagonal(off).add_(1.0)
        F32, MF32 = _group_f32_pair(E, mesh, block)
        ldF = _psum_(2.0 * torch.sum(torch.log(torch.diagonal(F32, off).to(_F64))), mesh)
        del F32, E
        # G = MF (I + H) MF^T - I in f64 (G hides under the identity)
        MF64 = MF32.double()
        del MF32
        E64 = H.double()
        E64.diagonal(off).add_(1.0)
        G = _ring_mm(MF64, _ring_bt(E64, MF64, mesh), mesh)
        del E64, MF64
        G.diagonal(off).sub_(1.0)
        g1, g2 = _psum_(torch.stack([torch.sum(torch.diagonal(G, off)), torch.sum(G * G)]), mesh)
        del G
        ld = torch.where(g2 < _level2_tau(n), base + ldF + g1 - g2 / 2.0, torch.nan)
    X = _group_refined_solve(K, B, M32, n_refine, mesh)
    return X, ld, (M32, series, H)


def _group_kinv(M32, series, ZH, mesh, block):
    """This rank's rows of K^{-1}, f64: M^T M - M^T (Z M) (series) or W^T W,
    W = MF M (robust), each product reduced and scattered by (n, n/R) column
    blocks."""
    n_loc, n = M32.shape
    off, _ = comm.rows_of(n, mesh)
    Kinv = torch.empty((n_loc, n), dtype=_F64, device=M32.device)
    cols = [slice(c * n_loc, (c + 1) * n_loc) for c in range(mesh.size)]
    if series:
        M = M32.double()
        for c in cols:
            Kinv[:, c] = comm.reduce_scatter_rows(M.T @ M[:, c], mesh)
        del M
        ZM = _ring_mm(ZH, M32, mesh)
        for c in cols:
            Kinv[:, c] -= comm.reduce_scatter_rows(M32.T @ ZM[:, c], mesh)
        return Kinv
    E = ZH.clone()
    E.diagonal(off).add_(1.0)
    _F, MF32 = _group_f32_pair(E, mesh, block)
    del _F, E
    W = _ring_mm(MF32, M32, mesh).double()
    del MF32
    for c in cols:
        Kinv[:, c] = comm.reduce_scatter_rows(W.T @ W[:, c], mesh)
    return Kinv


class _GroupMpSolveAndLogdet(torch.autograd.Function):
    """Slabs of (K^{-1} B) and the replicated log det K, with the analytic
    backward of ``_MpSolveAndLogdet`` on slabs."""

    @staticmethod
    def forward(ctx, K, B, block, n_refine, mesh):
        X, ld, (M32, series, ZH) = _group_mp_core(K, B, mesh, block, n_refine)
        ctx.save_for_backward(K, M32, ZH, X)
        ctx.series, ctx.n_refine, ctx.block, ctx.mesh = series, n_refine, block, mesh
        return X, ld

    @staticmethod
    @first_order_only("sharded_mp_solve_and_logdet")
    def backward(ctx, Xbar, ldbar):
        K, M32, ZH, X = ctx.saved_tensors
        mesh = ctx.mesh
        Xb = Xbar.reshape(-1, 1) if Xbar.ndim == 1 else Xbar
        Xm = X.reshape(-1, 1) if X.ndim == 1 else X
        S = _group_refined_solve(K, Xb.contiguous(), M32, ctx.n_refine, mesh)
        Kbar = None
        if ctx.needs_input_grad[0]:
            Kbar = _group_kinv(M32, ctx.series, ZH, mesh, ctx.block)
            Kbar.mul_(ldbar)
            Kbar.addmm_(S, comm.gather_rows(Xm.contiguous(), mesh).T, alpha=-1.0)
        return Kbar, S.reshape(Xbar.shape), None, None, None


def sharded_mp_solve_and_logdet(K, B, mesh, axis_name="shard", block=512,
                                n_refine=DEFAULT_REFINE_ITERS):
    """(K^{-1} B, log det K) to ~f64 accuracy with one f64 (n, n) product,
    on the mesh (on a group mesh: the slabs of K, B and K^{-1} B, and the
    replicated log det).  B is (n,) or (n, m) with small m.  Differentiable
    through the analytic backward; a non-PD or f32-intractable K gives NaN,
    which the criteria map to +inf."""
    if is_group(mesh):
        return _GroupMpSolveAndLogdet.apply(K, B, block, n_refine, mesh)
    return _MpSolveAndLogdet.apply(K, B, block, n_refine)
