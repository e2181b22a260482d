# tests/test_torch_capture.py
"""gpmp_tpu_torch.ops.capture on the CPU: the graph's bookkeeping (the
launch state it holds, the launches it counts, the functions it refuses)
with the CUDA stream and graph calls stood in for, and the samplers' log
target running a criterion that is refused as it is."""

import contextlib
import gc
import weakref

import pytest
import torch

from gpmp_tpu_torch import config
from gpmp_tpu_torch.mcmc import param_posterior as pp
from gpmp_tpu_torch.ops import capture, gram


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def replay(self):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """The stream and graph calls do nothing, and synchronizing calls raise
    while the sync debug mode is "error", as on the card."""
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: mode.update(now=m))

    def host_read(t):
        if mode["now"] == "error":
            raise RuntimeError("called a synchronizing CUDA operation")
        return float(t.sum())

    return host_read


@capture.cached(maxsize=1)
def _workspace(n):
    return n, (torch.zeros(n, dtype=torch.float64), torch.ones(1, dtype=torch.int32))


def test_graph_holds_and_counts_what_it_captured(fake_cuda):
    """The graph keeps the cached tensors its launches fetched alive once
    the cache drops them, and counts its launches once per replay (the
    warm-up's once)."""
    def fn(x):
        _n, (part, _ticket) = _workspace(x.shape[0])
        gram.K1_LAUNCHES += 1
        return x + part, 2.0 * x

    _workspace.cache_clear()
    x = torch.arange(4.0, dtype=torch.float64)
    before = gram.K1_LAUNCHES
    try:
        graph = capture.Graph(fn, (x,))
        assert gram.K1_LAUNCHES == before + 1  # the warm-up ran; the capture runs per replay
        refs = [weakref.ref(t) for t in _workspace(4)[1]]
        _workspace(5)  # the cache (maxsize 1) drops n = 4's tensors
        gc.collect()
        assert all(r() is not None for r in refs)
        assert all(t is r() for t, r in zip(graph.held, refs, strict=True))
        out = graph(x + 1.0)
        assert isinstance(out, tuple) and len(out) == 2
        assert gram.K1_LAUNCHES == before + 2
        graph(x)
        assert gram.K1_LAUNCHES == before + 3
        # no capture is in progress after it
        assert capture._HOLDING == []
    finally:
        _workspace.cache_clear()
        gram.K1_LAUNCHES = before


def test_graph_refuses_a_function_that_reads_back(fake_cuda):
    """no_host_reads: a function that synchronizes (a branch on a device
    value) is refused before its capture, and the sync mode is restored;
    another error is raised as it is."""
    host_read = fake_cuda

    def branching(x):
        return x if host_read(x) > 0 else -x

    with pytest.raises(capture.ReadsBack):
        capture.Graph(branching, (torch.ones(3),), no_host_reads=True)
    assert torch.cuda.get_sync_debug_mode() == 0
    capture.Graph(branching, (torch.ones(3),))  # without the probe it is captured

    calls = []

    def failing(x):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("another error")
        return x

    with pytest.raises(RuntimeError, match="another error"):
        capture.Graph(failing, (torch.ones(3),), no_host_reads=True)


def test_log_target_runs_a_refused_criterion_as_it_is(fake_cuda, monkeypatch):
    """The samplers' log target: a criterion that reads the card back is
    refused once per (kind, shape, dtype, device, engine) and then runs as
    written, with no graph replayed; a capturable one replays its graph."""
    config.set_device("cpu")
    host_read = fake_cuda
    wrapped = pp._WrappedCriterion(lambda p, x, z: (p * p).sum() + host_read(x) * 0.0,
                                   torch.ones(2, dtype=torch.float64), None)
    lp = pp._make_log_prob(wrapped, None, None)
    q = torch.tensor([0.5, -1.0], dtype=torch.float64)
    replays = pp.GRAPH_REPLAYS
    made = []
    graph_cls = capture.Graph

    def counting_graph(*args, **kwargs):
        made.append(kwargs["no_host_reads"])
        return graph_cls(*args, **kwargs)

    monkeypatch.setattr(capture, "Graph", counting_graph)
    for kind in ("value", "value+grad", "value"):
        assert lp._graph(kind, q) is None
    assert made == [True, True] and pp.GRAPH_REPLAYS == replays
    try:
        config.set_chol_engine("mixed")
        assert lp._graph("value", q) is None and len(made) == 3
    finally:
        config.set_chol_engine("auto")
    assert float(lp(q)) == -1.25  # a CPU tensor runs as written

    plain = pp._make_log_prob(pp._WrappedCriterion(lambda p, x, z: (p * p).sum(), None, None),
                              None, None)
    (v,) = plain._graph("value", q)
    U, g = plain._graph("value+grad", q)
    assert float(v) == -1.25 and float(U) == 1.25 and torch.equal(g, 2 * q)
    assert pp.GRAPH_REPLAYS == replays + 2
