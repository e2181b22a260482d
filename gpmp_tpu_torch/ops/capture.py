# gpmp_tpu_torch/ops/capture.py
"""A sequence of the port's launches captured once as a CUDA graph and
replayed per call (``Graph``).

Two users: ``refine``'s f64 panel factorization, and the samplers' log
target (gpmp_tpu_torch.mcmc.param_posterior).  ``Graph`` owns what a
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
is instead.
"""

from __future__ import annotations

import functools

import torch

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
        _HOLDING.append(self.held)
        try:
            with torch.set_grad_enabled(grad), torch.cuda.graph(self.graph, stream=stream):
                out = fn(*self.inputs)
        finally:
            _HOLDING.pop()
        self.out = out if isinstance(out, tuple) else (out,)
        self.counts = []
        for (m, a), b in zip(counters, before):
            if getattr(m, a) != b:
                self.counts.append((m, a, getattr(m, a) - b))
            setattr(m, a, b)  # they run at each replay

    def _probe(self, fn):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*self.inputs)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            raise ReadsBack(f"{getattr(fn, '__qualname__', fn)} reads the card back: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def __call__(self, *inputs):
        with torch.no_grad():
            for dst, src in zip(self.inputs, inputs, strict=True):
                dst.copy_(src)
            self.graph.replay()
            out = tuple(t.clone() for t in self.out)
        for m, a, c in self.counts:
            setattr(m, a, getattr(m, a) + c)
        return out
