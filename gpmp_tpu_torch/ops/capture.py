# gpmp_tpu_torch/ops/capture.py
"""A sequence of the port's launches captured once as a CUDA graph and
replayed per call (``Graph``).

Its users: ``refine``'s f64 panel factorization, the MH and NUTS log
target (gpmp_tpu_torch.mcmc.param_posterior), and the population samplers'
criterion and SVGD step (gpmp_tpu_torch.mcmc.population).  ``Graph`` owns what a
replay needs beside the graph:

- the launch counters: the capture's launches are taken off the ``*_LAUNCHES``
  counters of ``ops`` and added back at each replay, so that a counter
  says what ran;
- the launch state the graph points into: the per-shape plans and
  workspaces that the kernels take as raw pointers come from caches that
  may drop them (``cached``); a capture keeps every tensor that its
  launches fetched from them for as long as the graph lives (``held``).

A function that reads the card back (``.item()``, ``.tolist()``, a branch
on a device value: the mixed engine's convergence tests) cannot be
captured, and a graph of it would freeze its branches.  With
``no_host_reads`` the function runs once more before the capture with
synchronizing calls made errors (``torch.cuda.set_sync_debug_mode``), and
``Graph`` raises ``ReadsBack`` if it makes one; the caller runs it as it
is instead.  ``reads_back`` asks the same of a function on either device
(such a function cannot run under torch.func.vmap either).
"""

from __future__ import annotations

import functools
import gc

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_HOLDING = []  # the held lists of the captures in progress


class ReadsBack(RuntimeError):
    """The function synchronizes with the host, so it is not captured."""


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def cached(maxsize):
    """``functools.lru_cache`` for launch state on the card (plans,
    workspaces): a capture in progress holds the tensors of every value it
    fetches, since its graph keeps their addresses."""

    def decorate(fn):
        inner = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kwargs):
            value = inner(*args, **kwargs)
            for held in _HOLDING:
                held.extend(t for t in _tensors(value) if not any(t is h for h in held))
            return value

        get.cache_clear, get.cache_info = inner.cache_clear, inner.cache_info
        return get

    return decorate


def _counters():
    from . import chol, distance, gram, mixed, refine, streamed

    return [(m, a) for m in (chol, distance, gram, mixed, refine, streamed)
            for a in sorted(vars(m)) if a.endswith("_LAUNCHES")]


def _no_sync(fn, inputs):
    """Run fn(*inputs) with synchronizing calls made errors; ReadsBack if it
    makes one."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*inputs)
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        raise ReadsBack(f"{getattr(fn, '__qualname__', fn)} reads the card back: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class _ScalarReads(TorchDispatchMode):
    """Raises ReadsBack at a scalar read of a tensor (``.item()``,
    ``float()``, ``bool()``: aten._local_scalar_dense)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise ReadsBack("a tensor value is read to the host")
        return func(*args, **(kwargs or {}))


def reads_back(fn, *inputs):
    """Whether ``fn(*inputs)`` reads a device value back to the host (the
    mixed Cholesky engine's convergence tests): on CUDA inputs a
    synchronizing call (``Graph``'s probe), on CPU inputs a scalar read.  A
    function that does cannot run under torch.func.vmap nor be captured.
    Runs ``fn`` once, without autograd."""
    with torch.no_grad():
        try:
            if inputs[0].is_cuda:
                _no_sync(fn, inputs)
            else:
                with _ScalarReads():
                    fn(*inputs)
        except ReadsBack:
            return True
    return False


class Graph:
    """``fn(*inputs)`` (a tensor or a tuple of tensors) captured once at the
    inputs' shapes and replayed per call on new inputs of those shapes.

    Before the capture ``fn`` runs once on the capture stream (PyTorch's
    warm-up: the library is built, the plans and workspaces are made,
    cuBLAS's and cuSOLVER's handles exist for that stream; its launches
    count).  ``grad``: the graph's inputs require grad (``fn`` takes its own
    gradients); else ``fn`` runs without autograd.  A replay copies the
    inputs in, replays, adds the captured launches to the counters and
    clones the outputs out of the graph's memory pool (a tuple)."""

    def __init__(self, fn, inputs, *, grad=False, no_host_reads=False):
        device = inputs[0].device
        self.inputs = tuple(t.detach().clone().requires_grad_(grad) for t in inputs)
        self.held = []
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.set_grad_enabled(grad), torch.cuda.stream(stream):
                fn(*self.inputs)
                if no_host_reads:
                    self._probe(fn)
        finally:
            torch.cuda.current_stream(device).wait_stream(stream)
        counters = _counters()
        before = [getattr(m, a) for m, a in counters]
        self.graph = torch.cuda.CUDAGraph()
        # a graph destroyed while another is being captured invalidates the
        # capture: collect the dead ones (those in reference cycles, which
        # only the cyclic collector frees) first, and keep the collector off
        # until the capture ends
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        _HOLDING.append(self.held)
        try:
            with torch.set_grad_enabled(grad), torch.cuda.graph(self.graph, stream=stream):
                out = fn(*self.inputs)
        finally:
            _HOLDING.pop()
            if collecting:
                gc.enable()
        self.out = out if isinstance(out, tuple) else (out,)
        self.counts = []
        for (m, a), b in zip(counters, before):
            if getattr(m, a) != b:
                self.counts.append((m, a, getattr(m, a) - b))
            setattr(m, a, b)  # they run at each replay

    def _probe(self, fn):
        _no_sync(fn, self.inputs)

    def __call__(self, *inputs):
        with torch.no_grad():
            for dst, src in zip(self.inputs, inputs, strict=True):
                dst.copy_(src)
            self.graph.replay()
            out = tuple(t.clone() for t in self.out)
        for m, a, c in self.counts:
            setattr(m, a, getattr(m, a) + c)
        return out
