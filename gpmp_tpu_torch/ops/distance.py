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

The full forward and pullback share one launch geometry, ``distance_plan``:
a persistent grid walking items (a strip of 32 lanes' 16-byte column groups
times a chunk of rows); each is one launch, the pullback finished by its
last block (csrc/fixed_sum.cuh) into a workspace cached per shape.  The
elementwise pullback's grid is ``elementwise_plan``'s.

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

import functools

import torch

import gpmp_tpu_torch.num as gnp
from . import _build, capture
from .autograd import plain_vjp, refuse_batched
from .mixed import _on_card, _sms_on

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
# K1d's geometry (csrc/distance.cu, checked against the built library once):
# blocks of THREADS threads; a lane owns the 16 / itemsize consecutive
# columns of one 16-byte access, a warp a strip of 32 such groups, and each
# warp of a block walks its rows of an item ROW_UNROLL at a step; an
# instance for each d up to EXACT_MAX_D, one for d up to MAX_D; the
# elementwise pullback's blocks have EW_THREADS threads.  Both grids take at
# most BLOCKS_PER_SM blocks an SM.
THREADS, ROW_UNROLL, EXACT_MAX_D, MAX_D, EW_THREADS = 256, 8, 8, 32, 256
WARPS = THREADS // 32
BLOCKS_PER_SM = 2


def distance_plan(n, m, itemsize, sms):
    """The full kernels' grid for D (n, m) in ``itemsize``-byte entries, on
    the CPU: (strips, chunk_rows, blocks).

    Strip s holds the columns [s W, s W + W), W = 32 * (16 // itemsize),
    lane l of a warp the 16 // itemsize columns from s W + l (16 // itemsize);
    chunk c the rows [c chunk_rows, (c + 1) chunk_rows), warp w of the block
    the rows c chunk_rows + w, + w + WARPS, ...; item t is (strip t %
    strips, chunk t // strips), and block b takes the items b, b + blocks,
    ... in order.  There are at most BLOCKS_PER_SM blocks an SM, and as many
    chunks (of a multiple of WARPS * ROW_UNROLL rows: whole steps) as keep
    the items within them, so that every block takes one item where the
    strips allow it (n = m = 1000 in f64 on the H100's 132 SMs: 16 strips x
    16 chunks of 64 rows, 256 blocks; n = m = 16384: 256 strips of all the
    rows, 256 blocks)."""
    if n <= 0 or m <= 0 or itemsize not in (4, 8) or sms <= 0:
        raise ValueError(f"distance_plan: n={n}, m={m}, itemsize={itemsize}, sms={sms}")
    strips = -(-m // (32 * (16 // itemsize)))
    target = BLOCKS_PER_SM * sms
    chunks = max(1, min(target // strips, -(-n // WARPS)))
    step = WARPS * ROW_UNROLL
    chunk_rows = -(-(-(-n // chunks)) // step) * step
    items = strips * -(-n // chunk_rows)
    return strips, chunk_rows, min(items, target)


def elementwise_plan(n, sms):
    """The elementwise pullback's grid on the CPU: its blocks (EW_THREADS
    threads; thread j of the grid takes the rows j, j + S, ..., S the grid's
    threads), enough for one row a thread, at most BLOCKS_PER_SM an SM."""
    if n <= 0 or sms <= 0:
        raise ValueError(f"elementwise_plan: n={n}, sms={sms}")
    return max(1, min(-(-n // EW_THREADS), BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, its geometry checked against this module's once."""
    lib = _build.load()
    want = (THREADS, ROW_UNROLL, EXACT_MAX_D, MAX_D, EW_THREADS)
    built = tuple(lib.gpmp_distance_geometry(q) for q in range(len(want)))
    if built != want:
        raise RuntimeError(f"csrc/distance.cu's K1d geometry (threads, rows a step, exact d, "
                           f"max d, elementwise threads) is {built}, not {want}")
    return lib


@functools.lru_cache(maxsize=64)
def _plan_on(device, n, m, itemsize):
    _library()
    return distance_plan(n, m, itemsize, _sms_on(device))


@capture.cached(maxsize=64)
def _pullback_workspace(device, n, m, d, dtype, elementwise):
    """The pullback's per-(device, n, m, d, dtype) workspace: its plan (the
    elementwise one's blocks), and raw pointers to the blocks' partial sums
    (MAX_D f64 a block) and to the ticket (int32, zero between launches:
    each launch resets it), beside the tensors that hold them."""
    if elementwise:
        _library()
        plan = (elementwise_plan(n, _sms_on(device)),)
    else:
        plan = _plan_on(device, n, m, torch.finfo(dtype).bits // 8)
    part = torch.empty(plan[-1] * MAX_D, dtype=torch.float64, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    return plan, part.data_ptr(), ticket.data_ptr(), (part, ticket)


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
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the kernels' compile-time maximum {MAX_D}")
    if loginvrho.shape != (d,):
        raise ValueError(f"loginvrho must have shape ({d},); got {tuple(loginvrho.shape)}")
    shape = (n,) if elementwise else (n, m)
    if dbar is not None and dbar.shape != shape:
        raise ValueError(f"dbar must be {shape}; got {tuple(dbar.shape)}")
    return n, m, d


def _suffix(x):
    return "f64" if x.dtype == torch.float64 else "f32"


def scaled_distance_cuda(loginvrho, x, y):
    """K1d on the card: (n, m) distances, one launch on distance_plan's grid."""
    global K1D_LAUNCHES
    n, m, d = _check_cuda_args(loginvrho, x, y)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    strips, chunk_rows, blocks = _plan_on(x.device, n, m, x.element_size())
    _build.launch("K1d distance", getattr(_library(), f"gpmp_distance_{_suffix(x)}"), x.device,
                  x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(), out.data_ptr(), n, m, d,
                  strips, chunk_rows, blocks)
    K1D_LAUNCHES += 1
    return out


def scaled_distance_pullback_cuda(dbar, loginvrho, x, y):
    """K1d pullback on the card: grad_l <dbar, D(l)>, float64 (d,).

    One launch on distance_plan's grid, finished by its last block (fixed
    order, no atomics on values: bitwise reproducible)."""
    global K1D_PULLBACK_LAUNCHES
    n, m, d = _check_cuda_args(loginvrho, x, y, dbar=dbar)
    if n == 0 or m == 0:
        return torch.zeros(d, dtype=torch.float64, device=x.device)
    (strips, chunk_rows, blocks), part, ticket, _ = _pullback_workspace(
        x.device, n, m, d, x.dtype, False)
    out = torch.empty(d, dtype=torch.float64, device=x.device)
    _build.launch("K1d distance pullback",
                  getattr(_library(), f"gpmp_distance_pullback_{_suffix(x)}"), x.device,
                  dbar.data_ptr(), x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(), part,
                  ticket, out.data_ptr(), n, m, d, strips, chunk_rows, blocks)
    K1D_PULLBACK_LAUNCHES += 1
    return out


def scaled_distance_elementwise_cuda(loginvrho, x, y):
    """K1d on the card, elementwise: (n,) distances of matching rows."""
    global K1D_LAUNCHES
    n, _m, d = _check_cuda_args(loginvrho, x, y, elementwise=True)
    out = torch.empty((n,), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    _build.launch("K1d distance elementwise",
                  getattr(_library(), f"gpmp_distance_elementwise_{_suffix(x)}"), x.device,
                  x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(), out.data_ptr(), n, d)
    K1D_LAUNCHES += 1
    return out


def scaled_distance_elementwise_pullback_cuda(dbar, loginvrho, x, y):
    """K1d pullback on the card, elementwise: float64 (d,), one launch on
    elementwise_plan's grid, finished as the full one."""
    global K1D_PULLBACK_LAUNCHES
    n, _m, d = _check_cuda_args(loginvrho, x, y, dbar=dbar, elementwise=True)
    if n == 0:
        return torch.zeros(d, dtype=torch.float64, device=x.device)
    (blocks,), part, ticket, _ = _pullback_workspace(x.device, n, n, d, x.dtype, True)
    out = torch.empty(d, dtype=torch.float64, device=x.device)
    _build.launch("K1d distance elementwise pullback",
                  getattr(_library(), f"gpmp_distance_elementwise_pullback_{_suffix(x)}"),
                  x.device, dbar.data_ptr(), x.data_ptr(), y.data_ptr(), loginvrho.data_ptr(),
                  part, ticket, out.data_ptr(), n, d, blocks)
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
    backward under create_graph, recorded (exact second derivatives).
    Under torch.func.vmap the rule is generated from these: on CPU tensors
    the plain versions batch, on CUDA tensors K1d has no batched form and
    raises."""

    generate_vmap_rule = True

    @staticmethod
    def forward(loginvrho, x, y, elementwise):
        if _on_card(x):
            refuse_batched("K1d scaled_distance", loginvrho, x, y)
            fn = scaled_distance_elementwise_cuda if elementwise else scaled_distance_cuda
            return fn(loginvrho.contiguous(), x.contiguous(), y.contiguous())
        return _plain_for(elementwise)(loginvrho, x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        loginvrho, x, y, elementwise = inputs
        ctx.save_for_backward(loginvrho, x, y)
        ctx.elementwise = elementwise

    @staticmethod
    def backward(ctx, dbar):
        loginvrho, x, y = ctx.saved_tensors
        plain = _plain_for(ctx.elementwise)
        if torch.is_grad_enabled():
            return (*plain_vjp(plain, (loginvrho, x, y), ctx.needs_input_grad[:3], dbar), None)
        gl = None
        if ctx.needs_input_grad[0]:
            if _on_card(x):
                refuse_batched("K1d scaled_distance pullback", dbar, loginvrho, x, y)
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
