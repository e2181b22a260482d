# gpmp_tpu_torch/ops/gram.py
"""Matern gram matrix and its parameter pullback: kernels and plain versions.

K1 (``matern_gram_cuda``) computes
    K_ij = s2 * k_p(||e^l * x_i - e^l * y_j||)  (+ 10 * s2 * eps on the
    diagonal when ``same``), theta = [log s2, l_1..l_d],
and K2 (``matern_gram_pullback_cuda``) computes grad_theta <Kbar, K(theta)>
without forming dK/dtheta.  K1m (``maternp_kernel_cuda``,
``maternp_kernel_backward_cuda``) is the Matern polynomial alone, for
covariances that compose it with ``gnp.scaled_distance`` (K1d,
ops/distance.py): K = k_p(D) and Dbar = Kbar k_p'(D), one elementwise pass
each.  All are hand-written CUDA (gpmp_tpu_torch/csrc/matern_gram.cu).
They replace the gram construction that the JAX package composes from
gpmp_tpu/num cdist/scaled_distance and gpmp_tpu/kernel/matern.py, and its
autodiff pullback.

``matern_gram`` and ``maternp_kernel`` dispatch on the tensors' device: CPU
tensors take the plain PyTorch versions (``matern_gram_plain``,
``matern_gram_pullback_plain``, ``maternp_kernel_plain``,
``maternp_kernel_backward_plain``), CUDA tensors launch the kernels or
raise.  There is no fallback from one to the other, and the plain versions
call only plain versions.

``K1_LAUNCHES``, ``K2_LAUNCHES``, ``K1M_LAUNCHES`` and
``K1M_BACKWARD_LAUNCHES`` count kernel launches (one per wrapper call that
launched); the plain versions count nothing.

eps in the nugget is the machine epsilon of the tensors' dtype (the
working dtype when the tensors come from ``gnp``).
"""

from __future__ import annotations

import math
from functools import partial

import torch

import gpmp_tpu_torch.num as gnp
from . import _build, distance
from .autograd import plain_vjp
from .mixed import _on_card

K1_LAUNCHES = 0
K2_LAUNCHES = 0
K1M_LAUNCHES = 0
K1M_BACKWARD_LAUNCHES = 0


# ----------------------------------------------------------------------------
# Matern polynomial (shared by the plain versions and the kernels)
# ----------------------------------------------------------------------------
def _maternp_poly_coeffs(p: int):
    """Coefficients a_k of the half-integer Matern polynomial.

    K(h) = exp(-2 sqrt(nu) h) * sum_{k=0}^{p} a_k (4 sqrt(nu) h)^k with
    a_k = Gamma(p+1)/Gamma(2p+1) * (2p-k)! / ((p-k)! k!); a_0 = 1.
    """
    return [
        math.exp(
            math.lgamma(p + 1)
            - math.lgamma(2 * p + 1)
            + math.lgamma(2 * p - k + 1)
            - math.lgamma(p - k + 1)
            - math.lgamma(k + 1)
        )
        for k in range(p + 1)
    ]


def _maternp_dpoly_coeffs(p: int):
    """b_k with k_p'(h) = c e^{-ch} sum_k b_k (2ch)^k: b_k = 2(k+1)a_{k+1} - a_k."""
    a = _maternp_poly_coeffs(p) + [0.0]
    return [2.0 * (k + 1) * a[k + 1] - a[k] for k in range(p + 1)]


def _horner(coeffs, t):
    poly = torch.full_like(t, coeffs[-1])
    for ck in reversed(coeffs[:-1]):
        poly = poly * t + ck
    return poly


# ----------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are held to)
# ----------------------------------------------------------------------------
def maternp_kernel_plain(p: int, h):
    """Matern kernel with half-integer regularity nu = p + 1/2 (torch ops).

    Polynomial form evaluated by Horner's rule; K(inf) = 0.
    """
    p = int(p)
    c = 2.0 * math.sqrt(p + 0.5)
    if p == 0:
        return torch.exp(-c * h)
    out = torch.exp(-c * h) * _horner(_maternp_poly_coeffs(p), 2.0 * c * h)
    return torch.where(torch.isinf(h), torch.zeros_like(out), out)


def maternp_kernel_backward_plain(p: int, h, kbar):
    """Hbar = Kbar k_p'(h), k_p'(h) = c e^{-ch} sum_k b_k (2ch)^k; 0 at h = inf."""
    c = 2.0 * math.sqrt(int(p) + 0.5)
    dk = c * torch.exp(-c * h) * _horner(_maternp_dpoly_coeffs(int(p)), 2.0 * c * h)
    return torch.where(torch.isinf(h), 0.0, kbar * dk)


def matern_gram_plain(x, y, p, theta, same=False):
    """K(x, y; theta) from torch ops: the JAX package's composition."""
    sigma2 = torch.exp(theta[0])
    K = sigma2 * maternp_kernel_plain(p, distance.scaled_distance_plain(theta[1:], x, y))
    if same:
        nugget = 10.0 * sigma2 * torch.finfo(x.dtype).eps
        K = K + nugget * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return K


def matern_gram_pullback_plain(kbar, x, y, p, theta, same=False):
    """grad_theta <kbar, K(x, y; theta)> from torch ops, accumulated in float64.

    Rows are taken in blocks under gnp._CDIST_BLOCK_BUDGET, as in gnp.cdist.
    Coincident points (h = 0) contribute 0 to the log-inverse-range
    components (the zero subgradient of gnp._safe_sqrt).
    """
    p = int(p)
    n, d = x.shape
    m = y.shape[0]
    sigma2 = torch.exp(theta[0])
    invrho = torch.exp(theta[1:])
    xs, ys = invrho * x, invrho * y
    c = 2.0 * math.sqrt(p + 0.5)
    a, b = _maternp_poly_coeffs(p), _maternp_dpoly_coeffs(p)
    block = max(1, gnp._CDIST_BLOCK_BUDGET // (m * max(d, 1)))
    g0, gl = [], []
    for i in range(0, n, block):
        sq = (xs[i:i + block, None, :] - ys[None, :, :]) ** 2
        h = torch.sqrt(torch.sum(sq, dim=-1))
        e = torch.exp(-c * h)
        t = 2.0 * c * h
        finite = ~torch.isinf(h)
        kv = torch.where(finite, e * _horner(a, t), 0.0)
        kb = kbar[i:i + block]
        g0.append(torch.sum((kb * (sigma2 * kv)).double()))
        pos = finite & (h > 0.0)
        w = torch.where(pos, kb * sigma2 * (c * e * _horner(b, t))
                        / torch.where(pos, h, 1.0), 0.0)
        gl.append(torch.sum((w[..., None] * sq).double(), dim=(0, 1)))
    g_sigma = torch.stack(g0).sum()
    if same:
        nugget = 10.0 * sigma2 * torch.finfo(x.dtype).eps
        g_sigma = g_sigma + torch.sum((torch.diagonal(kbar) * nugget).double())
    return torch.cat([g_sigma.reshape(1), torch.stack(gl).sum(0)])


# ----------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ----------------------------------------------------------------------------
_COEF = {}  # (p, device) -> float64 [c, a_0..a_p, b_0..b_p] on the device


def _coef_tensor(p, device):
    key = (p, device)
    t = _COEF.get(key)
    if t is None:
        vals = [2.0 * math.sqrt(p + 0.5), *_maternp_poly_coeffs(p),
                *_maternp_dpoly_coeffs(p)]
        t = _COEF[key] = torch.tensor(vals, dtype=torch.float64, device=device)
    return t


def _check_cuda_args(x, y, theta, p, same, kbar=None):
    """Validate the kernels' arguments before anything is built or launched."""
    tensors = (x, y, theta) if kbar is None else (kbar, x, y, theta)
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("matern gram kernels take CUDA tensors on one device")
        if t.dtype not in (torch.float64, torch.float32) or t.dtype != x.dtype:
            raise ValueError("matern gram kernels take float64 or float32 "
                             "tensors of one dtype")
        if not t.is_contiguous():
            raise ValueError("matern gram kernels take contiguous tensors")
    if x.ndim != 2 or y.ndim != 2 or y.shape[1] != x.shape[1]:
        raise ValueError(f"x, y must be (n, d), (m, d); got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    n, d = x.shape
    m = y.shape[0]
    if d < 1:
        raise ValueError("the kernels need d >= 1")
    if theta.shape != (d + 1,):
        raise ValueError(f"theta must have shape ({d + 1},); got {tuple(theta.shape)}")
    if p < 0:
        raise ValueError(f"p must be >= 0; got {p}")
    if same and n != m:
        raise ValueError("same=True needs x and y with the same rows")
    if kbar is not None and kbar.shape != (n, m):
        raise ValueError(f"kbar must be ({n}, {m}); got {tuple(kbar.shape)}")
    return n, m, d


def _load_for(d):
    lib = _build.load()
    max_d = lib.gpmp_matern_max_d()
    if d > max_d:
        raise ValueError(f"d={d} exceeds the kernels' compile-time maximum {max_d}")
    return lib


def matern_gram_cuda(x, y, p, theta, same=False):
    """K1: the gram matrix on the card (launches one kernel)."""
    global K1_LAUNCHES
    n, m, d = _check_cuda_args(x, y, theta, p, same)
    lib = _load_for(d)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    fn = lib.gpmp_matern_gram_f64 if x.dtype == torch.float64 else lib.gpmp_matern_gram_f32
    coef = _coef_tensor(p, x.device)
    _build.launch("K1 matern_gram", fn, x.device, x.data_ptr(), y.data_ptr(), theta.data_ptr(),
            coef.data_ptr(), out.data_ptr(), n, m, d, p, int(same),
            torch.finfo(x.dtype).eps)
    K1_LAUNCHES += 1
    return out


def matern_gram_pullback_cuda(kbar, x, y, p, theta, same=False):
    """K2: grad_theta <kbar, K(theta)> on the card, float64 of shape (1 + d,).

    Two launches from one source: per-block partial sums, then a
    fixed-order reduction (no atomics, bitwise reproducible).
    """
    global K2_LAUNCHES
    n, m, d = _check_cuda_args(x, y, theta, p, same, kbar=kbar)
    lib = _load_for(d)
    out = torch.zeros(d + 1, dtype=torch.float64, device=x.device)
    if n == 0 or m == 0:
        return out
    nblocks = lib.gpmp_matern_pullback_blocks(n, m)
    partial = torch.empty((nblocks, d + 1), dtype=torch.float64, device=x.device)
    fn = (lib.gpmp_matern_pullback_f64 if x.dtype == torch.float64
          else lib.gpmp_matern_pullback_f32)
    coef = _coef_tensor(p, x.device)
    _build.launch("K2 matern_gram_pullback", fn, x.device, kbar.data_ptr(), x.data_ptr(),
            y.data_ptr(), theta.data_ptr(), coef.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, m, d, p, int(same), torch.finfo(x.dtype).eps)
    K2_LAUNCHES += 1
    return out


def _check_maternp_args(p, h, kbar=None):
    for t in (h,) if kbar is None else (h, kbar):
        if not t.is_cuda or t.device != h.device:
            raise ValueError("K1m maternp kernels take CUDA tensors on one device")
        if t.dtype not in (torch.float64, torch.float32) or t.dtype != h.dtype:
            raise ValueError("K1m maternp kernels take float64 or float32 tensors of one dtype")
        if not t.is_contiguous():
            raise ValueError("K1m maternp kernels take contiguous tensors")
    if kbar is not None and kbar.shape != h.shape:
        raise ValueError(f"kbar must be {tuple(h.shape)}; got {tuple(kbar.shape)}")
    if p < 0:
        raise ValueError(f"p must be >= 0; got {p}")
    return _build.load()


def maternp_kernel_cuda(p, h):
    """K1m on the card: k_p(h) elementwise, any shape (one launch)."""
    global K1M_LAUNCHES
    lib = _check_maternp_args(p, h)
    out = torch.empty_like(h)
    if h.numel() == 0:
        return out
    fn = lib.gpmp_maternp_f64 if h.dtype == torch.float64 else lib.gpmp_maternp_f32
    _build.launch("K1m maternp", fn, h.device, h.data_ptr(), _coef_tensor(p, h.device).data_ptr(),
                  out.data_ptr(), h.numel(), p)
    K1M_LAUNCHES += 1
    return out


def maternp_kernel_backward_cuda(p, h, kbar):
    """K1m backward on the card: kbar * k_p'(h) elementwise (one launch)."""
    global K1M_BACKWARD_LAUNCHES
    lib = _check_maternp_args(p, h, kbar)
    out = torch.empty_like(h)
    if h.numel() == 0:
        return out
    fn = (lib.gpmp_maternp_backward_f64 if h.dtype == torch.float64
          else lib.gpmp_maternp_backward_f32)
    _build.launch("K1m maternp backward", fn, h.device, h.data_ptr(), kbar.data_ptr(),
                  _coef_tensor(p, h.device).data_ptr(), out.data_ptr(), h.numel(), p)
    K1M_BACKWARD_LAUNCHES += 1
    return out


# ----------------------------------------------------------------------------
# Autograd and dispatch
# ----------------------------------------------------------------------------
class _MaternpKernel(torch.autograd.Function):
    """k_p(h) elementwise: K1m forward and backward on CUDA tensors, the
    plain versions on CPU tensors; under create_graph the backward is the
    plain composition's, recorded (exact second derivatives)."""

    @staticmethod
    def forward(ctx, h, p):
        ctx.save_for_backward(h)
        ctx.p = p
        if _on_card(h):
            return maternp_kernel_cuda(p, h.contiguous())
        return maternp_kernel_plain(p, h)

    @staticmethod
    def backward(ctx, kbar):
        (h,) = ctx.saved_tensors
        if torch.is_grad_enabled():
            (hbar,) = plain_vjp(partial(maternp_kernel_plain, ctx.p), (h,),
                                ctx.needs_input_grad[:1], kbar)
            return hbar, None
        if _on_card(h):
            return maternp_kernel_backward_cuda(ctx.p, h.contiguous(), kbar.contiguous()), None
        return maternp_kernel_backward_plain(ctx.p, h, kbar), None


def maternp_kernel(p: int, h):
    """Matern kernel with half-integer regularity nu = p + 1/2, elementwise
    on a tensor of distances h; K(inf) = 0; differentiable in h."""
    return _MaternpKernel.apply(h, int(p))


class MaternGram(torch.autograd.Function):
    """K(x, y; theta): K1 forward and K2 (the theta pullback) backward on CUDA
    tensors, the plain versions on CPU tensors.  The x and y cotangents come
    from the plain composition on either device (off the main path), and so
    does the whole backward under create_graph, recorded (exact second
    derivatives)."""

    @staticmethod
    def forward(ctx, x, y, theta, p, same):
        ctx.save_for_backward(x, y, theta)
        ctx.p, ctx.same = p, same
        if x.is_cuda:
            return matern_gram_cuda(x.contiguous(), y.contiguous(), p, theta.contiguous(), same)
        return matern_gram_plain(x, y, p, theta, same)

    @staticmethod
    def backward(ctx, kbar):
        x, y, theta = ctx.saved_tensors
        plain = partial(_gram_plain_xyt, ctx.p, ctx.same)
        if torch.is_grad_enabled():
            return (*plain_vjp(plain, (x, y, theta), ctx.needs_input_grad[:3], kbar), None, None)
        gx = gy = g = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gx, gy, _ = plain_vjp(plain, (x.detach().requires_grad_(ctx.needs_input_grad[0]),
                                          y.detach().requires_grad_(ctx.needs_input_grad[1]),
                                          theta.detach()),
                                  (*ctx.needs_input_grad[:2], False), kbar, create_graph=False)
        if ctx.needs_input_grad[2]:
            if kbar.is_cuda:
                g = matern_gram_pullback_cuda(kbar.contiguous(), x.contiguous(), y.contiguous(),
                                              ctx.p, theta.contiguous(), ctx.same)
            else:
                g = matern_gram_pullback_plain(kbar, x, y, ctx.p, theta, ctx.same)
            g = g.to(theta.dtype)
        return gx, gy, g, None, None


def _gram_plain_xyt(p, same, x, y, theta):
    return matern_gram_plain(x, y, p, theta, same)


def matern_gram(x, y, p, theta, same=False):
    """Matern gram K(x, y; theta), differentiable in theta (K2 on the card)
    and in x and y (the plain composition), twice as well (the plain
    composition).

    ``same=True`` (y is x) adds the 10 * s2 * eps nugget on the diagonal.
    """
    if not (x.device == y.device == theta.device):
        raise ValueError("x, y and theta must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return MaternGram.apply(x, y, theta, int(p), bool(same))
