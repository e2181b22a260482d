# gpmp_tpu_torch/ops/distance.py
"""The anisotropic scaled distance and its pullback: K1d and plain versions.

K1d is hand-written CUDA (gpmp_tpu_torch/csrc/distance.cu).  It computes

    D_ij = || e^l x_i - e^l y_j ||        (``scaled_distance_cuda``, (n, m))
    D_i  = || e^l (x_i - y_i) ||          (``scaled_distance_elementwise_cuda``, (n,))

and the pullback for the log inverse ranges l,

    g_k = sum_ij Dbar_ij (e^l_k x_ik - e^l_k y_jk)^2 / D_ij

(``scaled_distance_pullback_cuda`` and its elementwise twin), with the term
0 where D_ij = 0: the zero subgradient of ``gnp._safe_sqrt``.  They replace
gpmp_tpu/num/__init__.py ``cdist``, ``scaled_distance``,
``scaled_distance_elementwise`` and their autodiff pullback, which user
covariances compose with ``kernel.maternp_kernel`` (K1m, ops/gram.py).

``scaled_distance`` and ``scaled_distance_elementwise`` (the entry points
behind gnp's) dispatch on the tensors' device: CPU tensors take the plain
versions (``scaled_distance_plain``, ``scaled_distance_pullback_plain`` and
the elementwise twins), CUDA tensors launch the kernels or raise.  There is
no fallback from one to the other.  The gradient for x or y is off the main
path (no caller in the package asks for it): it is computed only when
asked, from the plain composition, on either device.

``K1D_LAUNCHES`` and ``K1D_PULLBACK_LAUNCHES`` count kernel launches (full
and elementwise together); the plain versions count nothing.
"""

from __future__ import annotations

import torch

import gpmp_tpu_torch.num as gnp
from . import _build
from .autograd import plain_vjp
from .mixed import _on_card

K1D_LAUNCHES = 0
K1D_PULLBACK_LAUNCHES = 0


# ----------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are held to)
# ----------------------------------------------------------------------------
def scaled_distance_plain(loginvrho, x, y):
    """D from torch ops: the JAX package's composition, cdist of the scaled
    points (row-blocked under gnp._CDIST_BLOCK_BUDGET), differentiable."""
    invrho = torch.exp(loginvrho)
    return gnp.cdist(invrho * x, invrho * y)


def scaled_distance_elementwise_plain(loginvrho, x, y):
    """D_i = ||e^l (x_i - y_i)|| from torch ops, differentiable."""
    invrho = torch.exp(loginvrho)
    return gnp._safe_sqrt(torch.sum((invrho * (x - y)) ** 2, dim=1))


def _pullback_terms(dbar, sq):
    """sum over the leading axes of Dbar (diff^2) / D in float64; 0 where D = 0."""
    h = torch.sqrt(torch.sum(sq, dim=-1))
    pos = h > 0.0
    w = torch.where(pos, dbar / torch.where(pos, h, 1.0), 0.0)
    return torch.sum((w[..., None] * sq).double(), dim=tuple(range(sq.ndim - 1)))


def scaled_distance_pullback_plain(dbar, loginvrho, x, y):
    """grad_l <dbar, D(l)>, float64 of shape (d,), from torch ops; rows in
    blocks under gnp._CDIST_BLOCK_BUDGET, as in gnp.cdist."""
    n, d = x.shape
    m = y.shape[0]
    invrho = torch.exp(loginvrho)
    xs, ys = invrho * x, invrho * y
    block = max(1, gnp._CDIST_BLOCK_BUDGET // (max(m, 1) * max(d, 1)))
    g = torch.zeros(d, dtype=torch.float64, device=x.device)
    for i in range(0, n, block):
        g = g + _pullback_terms(dbar[i:i + block], (xs[i:i + block, None, :] - ys) ** 2)
    return g


def scaled_distance_elementwise_pullback_plain(dbar, loginvrho, x, y):
    """grad_l <dbar, D(l)> for D_i = ||e^l (x_i - y_i)||, float64 (d,)."""
    return _pullback_terms(dbar, (torch.exp(loginvrho) * (x - y)) ** 2)


# ----------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ----------------------------------------------------------------------------
def _check_cuda_args(loginvrho, x, y, dbar=None, elementwise=False):
    """Validate the kernels' arguments before anything is built or launched."""
    tensors = (loginvrho, x, y) if dbar is None else (dbar, loginvrho, x, y)
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("K1d distance kernels take CUDA tensors on one device")
        if t.dtype not in (torch.float64, torch.float32) or t.dtype != x.dtype:
            raise ValueError("K1d distance kernels take float64 or float32 tensors of one dtype")
        if not t.is_contiguous():
            raise ValueError("K1d distance kernels take contiguous tensors")
    if x.ndim != 2 or y.ndim != 2 or y.shape[1] != x.shape[1]:
        raise ValueError(f"x, y must be (n, d), (m, d); got {tuple(x.shape)}, {tuple(y.shape)}")
    n, d = x.shape
    m = y.shape[0]
    if elementwise and m != n:
        raise ValueError(f"the elementwise distance needs x and y of one shape; got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if d < 1:
        raise ValueError("the kernels need d >= 1")
    if loginvrho.shape != (d,):
        raise ValueError(f"loginvrho must have shape ({d},); got {tuple(loginvrho.shape)}")
    shape = (n,) if elementwise else (n, m)
    if dbar is not None and dbar.shape != shape:
        raise ValueError(f"dbar must be {shape}; got {tuple(dbar.shape)}")
    lib = _build.load()
    if d > lib.gpmp_distance_max_d():
        raise ValueError(f"d={d} exceeds the kernels' compile-time maximum "
                         f"{lib.gpmp_distance_max_d()}")
    return lib, n, m, d


def _suffix(x):
    return "f64" if x.dtype == torch.float64 else "f32"


def scaled_distance_cuda(loginvrho, x, y):
    """K1d on the card: (n, m) distances (one launch)."""
    global K1D_LAUNCHES
    lib, n, m, d = _check_cuda_args(loginvrho, x, y)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    _build.launch("K1d distance", getattr(lib, f"gpmp_distance_{_suffix(x)}"), x.device,
                  x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(), out.data_ptr(), n, m, d)
    K1D_LAUNCHES += 1
    return out


def scaled_distance_pullback_cuda(dbar, loginvrho, x, y):
    """K1d pullback on the card: grad_l <dbar, D(l)>, float64 (d,).

    Two launches from one C entry: per-block partial sums, then a
    fixed-order reduction (no atomics, bitwise reproducible)."""
    global K1D_PULLBACK_LAUNCHES
    lib, n, m, d = _check_cuda_args(loginvrho, x, y, dbar=dbar)
    out = torch.zeros(d, dtype=torch.float64, device=x.device)
    if n == 0 or m == 0:
        return out
    partial = torch.empty((lib.gpmp_distance_pullback_blocks(n, m), d), dtype=torch.float64,
                          device=x.device)
    _build.launch("K1d distance pullback",
                  getattr(lib, f"gpmp_distance_pullback_{_suffix(x)}"), x.device,
                  dbar.data_ptr(), x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), n, m, d)
    K1D_PULLBACK_LAUNCHES += 1
    return out


def scaled_distance_elementwise_cuda(loginvrho, x, y):
    """K1d on the card, elementwise: (n,) distances of matching rows."""
    global K1D_LAUNCHES
    lib, n, _m, d = _check_cuda_args(loginvrho, x, y, elementwise=True)
    out = torch.empty((n,), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    _build.launch("K1d distance elementwise",
                  getattr(lib, f"gpmp_distance_elementwise_{_suffix(x)}"), x.device,
                  x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(), out.data_ptr(), n, d)
    K1D_LAUNCHES += 1
    return out


def scaled_distance_elementwise_pullback_cuda(dbar, loginvrho, x, y):
    """K1d pullback on the card, elementwise: float64 (d,)."""
    global K1D_PULLBACK_LAUNCHES
    lib, n, _m, d = _check_cuda_args(loginvrho, x, y, dbar=dbar, elementwise=True)
    out = torch.zeros(d, dtype=torch.float64, device=x.device)
    if n == 0:
        return out
    partial = torch.empty((lib.gpmp_distance_elementwise_blocks(n), d), dtype=torch.float64,
                          device=x.device)
    _build.launch("K1d distance elementwise pullback",
                  getattr(lib, f"gpmp_distance_elementwise_pullback_{_suffix(x)}"), x.device,
                  dbar.data_ptr(), x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), n, d)
    K1D_PULLBACK_LAUNCHES += 1
    return out


# ----------------------------------------------------------------------------
# Autograd and dispatch
# ----------------------------------------------------------------------------
def _plain_for(elementwise):
    return scaled_distance_elementwise_plain if elementwise else scaled_distance_plain


class _ScaledDistance(torch.autograd.Function):
    """D(l; x, y): K1d forward and pullback on CUDA tensors, the plain
    versions on CPU tensors.  The x and y cotangents come from the plain
    composition on either device (off the main path), and so does the whole
    backward under create_graph, recorded (exact second derivatives)."""

    @staticmethod
    def forward(ctx, loginvrho, x, y, elementwise):
        ctx.save_for_backward(loginvrho, x, y)
        ctx.elementwise = elementwise
        if _on_card(x):
            fn = scaled_distance_elementwise_cuda if elementwise else scaled_distance_cuda
            return fn(loginvrho.contiguous(), x.contiguous(), y.contiguous())
        return _plain_for(elementwise)(loginvrho, x, y)

    @staticmethod
    def backward(ctx, dbar):
        loginvrho, x, y = ctx.saved_tensors
        plain = _plain_for(ctx.elementwise)
        if torch.is_grad_enabled():
            return (*plain_vjp(plain, (loginvrho, x, y), ctx.needs_input_grad[:3], dbar), None)
        gl = None
        if ctx.needs_input_grad[0]:
            if _on_card(x):
                fn = (scaled_distance_elementwise_pullback_cuda if ctx.elementwise
                      else scaled_distance_pullback_cuda)
                g = fn(dbar.contiguous(), loginvrho.contiguous(), x.contiguous(), y.contiguous())
            else:
                fn = (scaled_distance_elementwise_pullback_plain if ctx.elementwise
                      else scaled_distance_pullback_plain)
                g = fn(dbar, loginvrho, x, y)
            gl = g.to(loginvrho.dtype)
        gx = gy = None
        need = (ctx.needs_input_grad[1], ctx.needs_input_grad[2])
        if any(need):
            _, gx, gy = plain_vjp(plain, (loginvrho.detach(), x.detach().requires_grad_(need[0]),
                                          y.detach().requires_grad_(need[1])),
                                  (False, *need), dbar, create_graph=False)
        return gl, gx, gy, None


def _dispatch(loginvrho, x, y, elementwise):
    if not (x.device == y.device == loginvrho.device):
        raise ValueError("loginvrho, x and y must lie on one device")
    # a scalar (isotropic) loginvrho broadcasts over the d columns, as in
    # the JAX package; broadcast_to sums its gradient back
    loginvrho = torch.broadcast_to(loginvrho, (x.shape[-1],))
    return _ScaledDistance.apply(loginvrho, x, y, elementwise)


def scaled_distance(loginvrho, x, y):
    """(n, m) distances ||e^l x_i - e^l y_j||, differentiable."""
    return _dispatch(loginvrho, x, y, False)


def scaled_distance_elementwise(loginvrho, x, y):
    """(n,) distances ||e^l (x_i - y_i)||, differentiable."""
    return _dispatch(loginvrho, x, y, True)
