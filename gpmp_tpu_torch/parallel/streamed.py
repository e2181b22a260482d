# gpmp_tpu_torch/parallel/streamed.py
"""Single-card large-n mixed engine with the f64 covariance streamed.

Counterpart of gpmp_tpu/parallel/streamed.py, with its names.  The mesh's
resident mixed branch (gpmp_tpu_torch.parallel.mixed) holds the f64 (n, n)
covariance and its backward's temporaries: 9.0 (n, n) f32 units for one REML
value+grad, measured on an H100, so past n ~ 43k it needs more than 0.85 of
an 80 GB card.  This engine never holds K in float64.  The mathematics are those of the
mixed engine (f32 Cholesky preconditioner, factorization-residual logdet
identity, refined solves, analytic backward), with the covariance
evaluated from the kernel in row chunks:

  value:  log det K = 2 sum log diag L32 + log det(I + M R M^T),
          R = K - L32 L32^T in f64 arithmetic (K10r), the trace series
          from row chunks of H = M R M^T (K10t);
  solves: f32-preconditioner refinement (K6) where each f64 residual
          B - K X reads the two-float pair K32 + E32 (ff mode, K10m) or
          recomputes f64 kernel rows (recompute mode);
  grad:   Kbar = ldbar K^{-1} - S X^T is never formed: K^{-1} is built by
          row chunks into f32 (its identity part M^T M summed in f64), and
          <Kbar, dK/dtheta> runs through the f32 kernel chain (the f32
          K1d/K1m backward kernels) chunk by chunk, accumulated in f64.
          Gradient envelope: ~1e-5 relative per component, <= 1e-3 for
          log sigma2 near an optimum (the class envelope of the f32 series
          and contraction, as in the JAX package).

Two storage modes, chosen by a peak-bytes model against the card's memory
(``choose_mode``):

- ``ff``: K is resident as (K32, E32), E32 = f32(K64 - K32), built by one
  streamed f64 kernel pass (K10b); representation error ~eps32^2 |K|.
- ``recompute``: only K32 (the ridge folded in at the build) stays for the
  factorization; every f64 residual re-streams the kernel in row chunks.

The kernels of this path: K1d/K1m (the f64 gram rows and panels, the f32
pullback), K10b, K10r, K5 (``_block_tri_inv``), K10t, K6 and K10m
(gpmp_tpu_torch.ops.streamed, ops.mixed).  The products around them are
``torch.matmul`` (f32 stays f32 under the TF32 pin, f64 stays f64), as the
JAX package left them to XLA's dot; its row-block and panel sizes, which
bounded XLA's temporaries, become one size, ``chunk`` (<= 512 rows).

JAX's ``lax.cond`` and ``while_loop`` become host branches: one read of the
factor's log-determinant (the factorization's success), one of tr H^4 (the
series/robust gate), one per refinement sweep.  Torch frees a buffer when
its last reference goes: the forward keeps JAX's order (the residual before
the triangular inverse, L32 dropped once M32 exists, R once H exists), the
backward's residents are held as attributes of the autograd context and
dropped as soon as they are used.

Requires a dtype-polymorphic kernel (f32 inputs -> f32 gram), checked by
``streamed_applicable``.
"""

import math
import os
from functools import partial

import torch

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.ops.autograd import first_order_only
from gpmp_tpu_torch.config import get_device
from gpmp_tpu_torch.ops import mixed as _mixed
from gpmp_tpu_torch.ops import streamed as _ops
from gpmp_tpu_torch.ops.mixed import (
    DEFAULT_REFINE_ITERS,
    TRI_INV_BASE,
    _REFINE_FLOOR2,
    _RIDGE_FACTOR,
    _SOLVE_RTOL2,
)
from .likelihood import _chunked_gram_pullback, _diag_correction, _largest_divisor_leq

_F32 = torch.float32
_F64 = torch.float64
_EPS32 = torch.finfo(_F32).eps

# Series/robust gate on c4 = tr(H^4), as in the JAX package: c4 < 1e-6
# bounds the series' truncation at ~4e-9 absolute and max|lambda| <= 0.03.
_SERIES_C4_TAU = 1e-6

# Stream only where the resident engines cannot go.  GPMP_STREAM_N forces
# an explicit cutover n for tests and tuning; unset, the cutover follows the
# resident engines' peak-bytes model against the card.  Read at import.
_env_stream_n = os.environ.get("GPMP_STREAM_N")
STREAM_MIN_N = int(_env_stream_n) if _env_stream_n else None

# Peak-bytes model, in units of one (n, n) f32 buffer (4 n^2 bytes): the
# rise of torch.cuda.max_memory_allocated over what was held before, for one
# REML value+grad on bench_large_n.py's workload at its p0, measured on an
# NVIDIA H100 80GB HBM3 (700.00 W) by chip_smoke.py (phases 3d and 3e), plus
# half a unit for the caching allocator's rounding and splits.  Measured:
#   the mesh's resident mixed branch (parallel/mixed.py, the branch
#     ``_resident_fits`` guards: the f64 engine never streams) 9.01 at
#     n=16384 (its robust logdet);
#   ff 7.01 / 7.00, recompute 5.01 / 5.00 at n=16384 / 32768;
#   ff with the robust branch (its gate forced) 9.01 at 16384.
# 0.85 of this card is 16.83 units at n=32768 (resident) and 6.89 at
# n=51200 (streamed, recompute).
_RESIDENT_PEAK_UNITS = 9.6
_FF_PEAK_UNITS = 7.5
_RECOMPUTE_PEAK_UNITS = 5.5
_ROBUST_PEAK_UNITS = 9.5


def _device_bytes_cap():
    """0.85 of the configured card's memory; large on the CPU (RAM-bound,
    not this model's concern), as in the JAX package."""
    dev = get_device()
    if dev.type == "cuda":
        return int(0.85 * torch.cuda.get_device_properties(dev).total_memory)
    return 1 << 62


def _fits(units, n, cap_bytes):
    cap = _device_bytes_cap() if cap_bytes is None else cap_bytes
    return units * 4 * n * n <= cap


def _resident_fits(n, cap_bytes=None):
    return _fits(_RESIDENT_PEAK_UNITS, n, cap_bytes)


def choose_mode(n, cap_bytes=None):
    """'ff', 'recompute' or None (fits neither) by the peak-bytes model."""
    if _fits(_FF_PEAK_UNITS, n, cap_bytes):
        return "ff"
    if _fits(_RECOMPUTE_PEAK_UNITS, n, cap_bytes):
        return "recompute"
    return None


def _robust_fits(n, cap_bytes=None):
    """The second-level logdet (F, MF of I + H) adds two units to the ff
    residents; where it does not fit, the engine gives the series or NaN
    (the criterion maps NaN to +inf)."""
    return _fits(_ROBUST_PEAK_UNITS, n, cap_bytes)


def _level2_tau(n):
    """Gate of the second-level logdet defect: rms(G) <= 1e-6."""
    return 1e-12 * n * n


# --------------------------------------------------------------------------
# streamed kernel evaluation
# --------------------------------------------------------------------------
def _diag_self_mean(model, p, xi, chunk):
    """mean(diag K) from the self-branch covariance in O(n chunk), so that
    recompute mode knows the Cholesky ridge before the K32 build.  Each
    block is passed as one tensor twice, so the kernel's ``y is x``
    self-branch fires and the noise variance is on the diagonal."""
    n = xi.shape[0]
    diags = []
    for r0 in range(0, n, chunk):
        xb = xi[r0:r0 + chunk]
        diags.append(torch.diagonal(model.covariance(xb, xb, p)))
    return torch.cat(diags).mean()


def _build_pair(model, p, xi, corr, chunk, pair, ridge=0.0):
    """The f32 resident(s) from one streamed f64 kernel pass: row chunks of
    the cross-covariance (K1d/K1m), then K10b writes hi = f32(k) and
    lo = f32(k - hi) into rows of the (n, n) pair (``_build_ff``), or hi
    with the ridge on the diagonal into K32 alone (``_build_k32``).  The
    buffers are allocated once and filled in place."""
    n = xi.shape[0]
    hi = torch.empty((n, n), dtype=_F32, device=xi.device)
    lo = torch.empty_like(hi) if pair else None
    for r0 in range(0, n, chunk):
        k64 = model.covariance(xi[r0:r0 + chunk], xi, p)
        _ops.split_rows(k64, corr[r0:r0 + chunk], r0, hi, lo, ridge)
        del k64
    return hi, lo


def _k64_col_slab_recompute(model, p, xi, corr, c0, cb):
    """K64[c0:, c0:c0+cb] from the f64 kernel (K1d/K1m), the self-branch
    diagonal added in place.  (The JAX package's ``_k64_col_slab_ff`` has no
    counterpart: K10r reads the pair directly.)"""
    Ks = model.covariance(xi[c0:], xi[c0:c0 + cb], p)
    Ks[:cb].diagonal().add_(corr[c0:c0 + cb].to(Ks.dtype))
    return Ks


def _streamed_residual_recompute(model, p, xi, corr, L32, block):
    """R = K - L32 L32^T, f32 and symmetric, from f64 column panels of
    ``block`` columns (K10r, one launch per panel)."""
    n = xi.shape[0]
    R = torch.empty((n, n), dtype=_F32, device=xi.device)
    for c0 in range(0, n, block):
        w = min(block, n - c0)
        _ops.residual_panel(_k64_col_slab_recompute(model, p, xi, corr, c0, w), L32, c0, R)
    return R


def _cholesky_f32(K32, ridge=None):
    """(L32 row-major, info) of K32 (+ ridge I).  cuSOLVER and LAPACK return
    a column-major factor, so the upper factor's transpose is L32 row-major
    without a copy.  The ridge is added on K32's diagonal and the diagonal
    restored exactly afterwards (the ff pair must stay unridged): no (n, n)
    copy of K32."""
    if ridge is not None:
        diag = K32.diagonal().clone()
        K32.diagonal().add_(ridge)
    U, info = torch.linalg.cholesky_ex(K32, upper=True)
    if ridge is not None:
        K32.diagonal().copy_(diag)
    L32 = U.mT
    return (L32 if L32.is_contiguous() else L32.contiguous()), info


# --------------------------------------------------------------------------
# H = M R M^T by row blocks, trace series without holding H^2
# --------------------------------------------------------------------------
def _h_from_residual(M32, R32, cb):
    """H = (M32 R32) M32^T in row blocks; M32 is lower triangular, so a row
    block of M only reads the leading columns of R."""
    n = M32.shape[0]
    H = torch.empty((n, n), dtype=_F32, device=M32.device)
    for r0 in range(0, n, cb):
        r1 = min(n, r0 + cb)
        t = M32[r0:r1, :r1] @ R32[:r1]
        torch.matmul(t, M32.T, out=H[r0:r1])
    return H


def _h_traces(H, chunk):
    """(tr H, tr H^2, tr H^3, ~tr H^4) in f64, H^2 kept to one row chunk
    (torch.matmul), the four sums by K10t."""
    n = H.shape[0]
    acc = torch.zeros(4, dtype=_F64, device=H.device)
    for r0 in range(0, n, chunk):
        _ops.h_traces_chunk(H, H[r0:r0 + chunk] @ H, r0, acc)
    return acc


def _plain_f32_tri_pair(E32):
    """(F, F^{-1}) for a near-identity SPD f32 matrix (counterpart of
    gpmp_tpu/parallel/mixed.py ``_plain_f32_tri_pair``): the ridged f32
    Cholesky, NaN where it fails, and its inverse by K5's recursive doubling
    (n >= 4096) or a triangular solve.  E32 is the caller's temporary and
    takes the ridge in place (no (n, n) copy)."""
    n = E32.shape[0]
    E32.diagonal().add_(_RIDGE_FACTOR * _EPS32 * (torch.trace(E32) / n))
    F, info = _cholesky_f32(E32)
    if int(info) != 0:
        F.fill_(torch.nan)
    if n >= 4096:
        return F, _mixed._block_tri_inv(F, base=TRI_INV_BASE)
    eye = torch.eye(n, dtype=_F32, device=E32.device)
    return F, torch.linalg.solve_triangular(F, eye, upper=False)


def _eye_plus(H):
    """I + H in f32, as a new buffer."""
    E = H.clone()
    E.diagonal().add_(1.0)
    return E


def _streamed_level2_g(H, MF32, cb):
    """(tr G, |G|_F^2), G = MF (I + H) MF^T - I, one column block at a
    time: T[:, cols] = (I + H) MF[cols]^T and G[:, cols] = MF T[:, cols] - I
    in f64 (the cancellation needs it), H and MF promoted by row blocks, so
    no (n, n) f64 is held."""
    n = H.shape[0]
    g = torch.zeros(2, dtype=_F64, device=H.device)
    for c0 in range(0, n, cb):
        c1 = min(n, c0 + cb)
        mfc64t = MF32[c0:c1].double().T
        Tc = torch.empty((n, c1 - c0), dtype=_F64, device=H.device)
        Gc = torch.empty_like(Tc)
        for r0 in range(0, n, cb):
            torch.matmul(H[r0:r0 + cb].double(), mfc64t, out=Tc[r0:r0 + cb])
        Tc += mfc64t
        for r0 in range(0, n, cb):
            torch.matmul(MF32[r0:r0 + cb].double(), Tc, out=Gc[r0:r0 + cb])
        Gc[c0:c1].diagonal().sub_(1.0)
        g[0] += torch.sum(Gc[c0:c1].diagonal())
        g[1] += torch.sum(Gc * Gc)
    return g[0], g[1]


# --------------------------------------------------------------------------
# refined solves with a streamed residual
# --------------------------------------------------------------------------
def _matvec_recompute(model, p, xi, corr, chunk, X):
    """K @ X with f64 kernel rows re-streamed (K1d/K1m), an f64
    torch.matmul per row chunk."""
    n = xi.shape[0]
    out = torch.empty((n, X.shape[1]), dtype=X.dtype, device=X.device)
    for r0 in range(0, n, chunk):
        Kr = model.covariance(xi[r0:r0 + chunk], xi, p)
        Kr[:, r0:r0 + chunk].diagonal().add_(corr[r0:r0 + chunk].to(Kr.dtype))
        torch.matmul(Kr, X, out=out[r0:r0 + chunk])
    return out


def _residual_recompute(model, p, xi, corr, chunk, X, B):
    R = B - _matvec_recompute(model, p, xi, corr, chunk, X)
    return R, torch.stack([torch.sum(R * R), torch.sum(B * B)])


def _refined_solve_streamed(residual, B, M32, n_refine, apply=None):
    """The refinement of gpmp_tpu_torch.ops.mixed.refined_cholesky_solve
    with the early exit (floor, stagnation, n_refine) and the NaN guard, the
    residual (X, B) -> (B - K X, norms) given: one device read per sweep.
    ``apply``: R -> M^T (M R), default K6 on the square M32 (a group mesh
    passes its slab form)."""
    if apply is None:
        apply = partial(_mixed._apply, M32)
    squeeze = B.ndim == 1
    Bm = B.reshape(-1, 1) if squeeze else B
    X = apply(Bm)
    R, norms = residual(X, Bm)
    r2, r2_prev, it = _mixed._rel2(norms, Bm.dtype), math.inf, 0
    while r2 >= _REFINE_FLOOR2 and r2 < 0.25 * r2_prev and it < n_refine:
        X = X + apply(R)
        R, norms = residual(X, Bm)
        r2_prev, r2 = r2, _mixed._rel2(norms, Bm.dtype)
        it += 1
    if not r2 < _SOLVE_RTOL2:  # NaN compares False: a failed solve is NaN
        X = torch.full_like(X, torch.nan)
    return X.reshape(-1) if squeeze else X


# --------------------------------------------------------------------------
# backward pieces
# --------------------------------------------------------------------------
def _kinv_series_rows(M32, H, chunk, kblock=4096):
    """K^{-1} ~= M^T (I - H + H^2) M by row chunks, stored in f32: with
    t1 = (M^T)[rows] H and t2 = t1 H, K^{-1}[rows] = (M^T M)[rows] +
    (t2 - t1) M.  The identity part is summed in f64, as the resident
    engine's ``_mp_kinv`` does, over ``kblock`` rows of M promoted at a
    time; the O(|H|) correction stays f32.  (The JAX package forms all of it
    in f32: with cuBLAS's f32 products the trace term of log sigma2's
    gradient then left 1.02e-3 relative at n=16384 on an H100, above the
    class envelope, and 4.2e-6 with the f64 identity part; chip_smoke.py
    phase 3d.)  M is lower triangular, so (M^T)[rows] is zero left of the
    chunk and row k of M zero right of k."""
    n = M32.shape[0]
    Kinv = torch.empty((n, n), dtype=_F32, device=M32.device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        MtR = M32[r0:, r0:r1].T  # (c, n - r0): (M^T)[rows, r0:]
        t1 = MtR @ H[r0:]
        A = t1 @ H
        A -= t1
        del t1
        acc = (A @ M32).double()
        del A
        for k0 in range(r0, n, kblock):
            k1 = min(n, k0 + kblock)
            acc[:, :k1] += M32[k0:k1, r0:r1].T.double() @ M32[k0:k1, :k1].double()
        Kinv[r0:r1] = acc
    return Kinv


def _kinv_robust(M32, H):
    """K^{-1} ~= (MF M)^T (MF M), the second-level preconditioner."""
    _F, MF32 = _plain_f32_tri_pair(_eye_plus(H))
    del _F
    W = MF32 @ M32
    del MF32
    return W.T @ W


# --------------------------------------------------------------------------
# the operator
# --------------------------------------------------------------------------
class _StreamedOperator:
    """(covparam, B) -> (K^{-1} B, log det K) for K(covparam; xi) streamed
    from the kernel: the state make_streamed_sal closes over."""

    def __init__(self, model, xi, mode, n_refine, robust):
        n = xi.shape[0]
        # the kernel sees row chunks (views) against xi: its `y is x`
        # self-branch never fires, and _diag_correction adds the diagonal
        self.model, self.xi, self.n = model, xi, n
        self.xi32 = xi.to(_F32)
        self.mode, self.n_refine, self.robust = mode, n_refine, robust
        self.chunk = _largest_divisor_leq(n, 512)
        # K10r's recompute panels: 512 columns past 16k, as in the JAX package
        self.rblock = _largest_divisor_leq(n, 512 if n >= 16384 else 1024)

    def _residual(self, p, corr, K32, E32):
        if self.mode == "ff":
            return partial(_ops.ff_residual, K32, E32)  # K10m
        return partial(_residual_recompute, self.model, p, self.xi, corr, self.chunk)

    def forward(self, p, B):
        """(X, ld, saved); saved is None when the f32 factorization failed
        (X and ld are then NaN, as the JAX package's NaN factor makes them)."""
        n, chunk = self.n, self.chunk
        corr = _diag_correction(self.model, p, self.xi)
        if self.mode == "ff":
            K32, E32 = _build_pair(self.model, p, self.xi, corr, chunk, pair=True)
            L32, info = _cholesky_f32(K32, _RIDGE_FACTOR * _EPS32 * (torch.trace(K32) / n))
        else:
            ridge = _RIDGE_FACTOR * _EPS32 * float(_diag_self_mean(self.model, p, self.xi, chunk))
            K32, E32 = _build_pair(self.model, p, self.xi, corr, chunk, pair=False, ridge=ridge)
            L32, info = _cholesky_f32(K32)
            del K32  # recompute mode: K32 feeds only the factorization
            K32 = None
        base = 2.0 * torch.sum(torch.log(torch.diagonal(L32).double()))
        if int(info) != 0 or not math.isfinite(float(base)):
            nan = torch.full_like(B, torch.nan)
            return nan, torch.full_like(base, torch.nan), None
        # the residual before the triangular inverse: R needs L32 but not M32
        if self.mode == "ff":
            R32 = _ops.streamed_residual_ff(K32, E32, L32, self.rblock)
        else:
            R32 = _streamed_residual_recompute(self.model, p, self.xi, corr, L32, self.rblock)
        M32 = _mixed._block_tri_inv(L32, base=TRI_INV_BASE)
        del L32
        H = _h_from_residual(M32, R32, chunk)
        del R32
        c1, c2, c3, c4 = _h_traces(H, chunk)
        c4_host = float(c4)
        if c4_host < _SERIES_C4_TAU:  # NaN compares False: robust, then NaN
            ld = base + c1 - c2 / 2.0 + c3 / 3.0 - c4 / 4.0
        elif self.robust:
            ld = self._robust_ld(H, base)
        else:
            ld = torch.full_like(base, torch.nan)
        X = _refined_solve_streamed(self._residual(p, corr, K32, E32), B, M32, self.n_refine)
        # only the scalar c4 is carried for the backward's gate; recompute
        # mode holds no K32 into the backward
        return X, ld, {"M32": M32, "H": H, "X": X, "K32": K32, "E32": E32, "corr": corr,
                       "c4": c4_host}

    def _robust_ld(self, H, base):
        F32, MF32 = _plain_f32_tri_pair(_eye_plus(H))
        g1, g2 = _streamed_level2_g(H, MF32, self.chunk)
        ld2 = base + 2.0 * torch.sum(torch.log(torch.diagonal(F32).double())) + g1 - g2 / 2.0
        return torch.where(g2 < _level2_tau(self.n), ld2, torch.nan)

    def backward(self, p, saved, Xbar, ldbar):
        """(pbar, Bbar); the residents in ``saved`` are dropped as soon as
        they are used."""
        if saved is None:
            return torch.full_like(p, torch.nan), torch.full_like(Xbar, torch.nan)
        squeeze = Xbar.ndim == 1
        Xb = Xbar.reshape(-1, 1) if squeeze else Xbar
        Xm = saved.pop("X")
        Xm = Xm.reshape(-1, 1) if squeeze else Xm
        M32, c4 = saved.pop("M32"), saved.pop("c4")
        residual = self._residual(p, saved.pop("corr"), saved.pop("K32"), saved.pop("E32"))
        S = _refined_solve_streamed(residual, Xb.contiguous(), M32, self.n_refine)
        del residual  # ff: the pair goes here
        H = saved.pop("H")
        if c4 < _SERIES_C4_TAU:
            Kinv32 = _kinv_series_rows(M32, H, self.chunk)
        elif self.robust:
            Kinv32 = _kinv_robust(M32, H)
        else:
            Kinv32 = None
        del M32, H
        if Kinv32 is None:
            pbar = torch.full(p.shape, torch.nan, dtype=_F64, device=p.device)
        else:
            # Kbar = ldbar K^{-1} - S X^T, formed one row chunk at a time
            S32, X32, lb = S.to(_F32), Xm.to(_F32), float(ldbar)
            diag_bar = lb * torch.diagonal(Kinv32) - torch.sum(S32 * X32, dim=1)
            pbar = _chunked_gram_pullback(
                self.model, p.to(_F32), self.xi32,
                lambda r0, r1: torch.addmm(Kinv32[r0:r1], S32[r0:r1], X32.T, beta=lb,
                                           alpha=-1.0),
                diag_bar, self.chunk)
        return pbar.to(p.dtype), S.reshape(Xbar.shape)


class _StreamedSolveAndLogdet(torch.autograd.Function):
    """The operator with its analytic backward (the JAX package's custom
    VJP): cotangents for covparam and B."""

    @staticmethod
    def forward(ctx, p, B, op):
        X, ld, saved = op.forward(p.detach(), B.detach())
        # not save_for_backward: the backward drops each resident after its
        # last use, which saved tensors would keep until it returns
        ctx.op, ctx.p, ctx.saved = op, p.detach(), saved
        return X, ld

    @staticmethod
    @first_order_only("streamed_mp_solve_and_logdet")
    def backward(ctx, Xbar, ldbar):
        saved, ctx.saved = ctx.saved, None
        pbar, Bbar = ctx.op.backward(ctx.p, saved, Xbar, ldbar)
        return pbar, Bbar, None


def make_streamed_sal(model, xi, mode=None, n_refine=DEFAULT_REFINE_ITERS,
                      robust=None, cap_bytes=None):
    """(covparam, B) -> (K^{-1} B, log det K), differentiable in (covparam,
    B), K streamed.  mode and robust default from the peak-bytes model."""
    xi = gnp.asarray(xi)
    n = xi.shape[0]
    if mode is None:
        mode = choose_mode(n, cap_bytes)
    if mode is None:
        raise ValueError(
            f"streamed engine: n={n} does not fit this card even in recompute mode; "
            "spread it over a group mesh of several cards (torch.distributed, "
            "parallel.make_mesh), whose resident branch holds n^2/R per rank.")
    if mode not in ("ff", "recompute"):
        raise ValueError(f"mode must be 'ff' or 'recompute'; got {mode!r}")
    if robust is None:
        robust = _robust_fits(n, cap_bytes)
    if _largest_divisor_leq(n, 512) < 64:
        raise ValueError(
            f"streamed engine needs a divisor of n={n} in [64, 512] for row chunking; "
            "pad n or use the resident engine.")
    op = _StreamedOperator(model, xi, mode, n_refine, robust)

    def sal(covparam, B):
        return _StreamedSolveAndLogdet.apply(gnp.asarray(covparam), gnp.asarray(B), op)

    return sal


def kernel_is_f32_polymorphic(model, covparam, xi):
    """True when f32 inputs give an f32 gram (the chain the pullback reruns
    in f32), probed on 2 x d f32 zeros."""
    try:
        x32 = torch.zeros((2, xi.shape[1]), dtype=_F32, device=xi.device)
        p32 = torch.zeros(tuple(covparam.shape), dtype=_F32, device=xi.device)
        with torch.no_grad():
            return model.covariance(x32, x32.clone(), p32).dtype == _F32
    except Exception:
        return False


def streamed_applicable(model, covparam, xi, mesh, axis_name):
    """Dispatcher predicate for parallel/likelihood.py."""
    if mesh is not None and (mesh.size != 1 or mesh.is_group):
        return False  # a group mesh never streams (nor does the JAX package's)
    n = xi.shape[0]
    if xi.dtype != _F64:
        return False
    if STREAM_MIN_N is not None:
        if n < STREAM_MIN_N:
            return False
    elif _resident_fits(n):
        return False  # a resident engine fits and is faster
    if _largest_divisor_leq(n, 512) < 64:
        return False
    if choose_mode(n) is None:
        return False
    from gpmp_tpu_torch.core.linalg import chol_engine

    if chol_engine(n) != "mixed":
        return False
    return kernel_is_f32_polymorphic(model, covparam, xi)


def streamed_mp_solve_and_logdet(model, covparam, xi, B, n_refine=DEFAULT_REFINE_ITERS,
                                 mode=None, robust=None, cap_bytes=None):
    """(K^{-1} B, log det K) with K(covparam; xi) streamed from the kernel:
    the single-card large-n mixed engine.  Differentiable in (covparam, B)
    through the analytic backward; NaN on failure."""
    sal = make_streamed_sal(model, xi, mode=mode, n_refine=n_refine, robust=robust,
                            cap_bytes=cap_bytes)
    return sal(covparam, B)
