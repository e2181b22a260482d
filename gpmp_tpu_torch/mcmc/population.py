# gpmp_tpu_torch/mcmc/population.py
"""Functions of a whole population of parameter vectors, for the SMC and
SVGD samplers: the port's counterpart of the JAX package's ``jax.vmap`` of
the criterion (gpmp_tpu/mcmc/param_posterior.py:399, mcmc/svgd.py:166) and
of the ``jit`` around it.

A population function runs by one of three routes, decided once per
function (and Cholesky engine) by a probe of the single function at one
member (``route``):

- ``"graph"``: on the card, for a criterion of parameter selection (a
  function marked ``capturable``), ``torch.func.vmap`` of it captured as
  one CUDA graph per population shape (``ops.capture.Graph``) and replayed
  per call: on the gram it launches K1p (and K2p under ``grad``) once a
  population;
- ``"vmap"``: ``torch.func.vmap`` run as it is (the CPU; other functions
  on the card);
- ``"particles"``: member by member, where the single function reads the
  device back (``ops.capture.reads_back``: the mixed Cholesky engine's
  convergence tests), which neither vmap nor a graph can take.

``GRAPH_REPLAYS`` counts the replays.
"""

import functools

import torch

from gpmp_tpu_torch.config import get_chol_engine
from gpmp_tpu_torch.ops import capture

GRAPH_REPLAYS = 0


def route(fn, member):
    """The route of a population function whose single form is ``fn``,
    probed at one member (a tensor of one parameter vector): one evaluation
    of ``fn`` as written (its ``uncaptured`` form where it has one: a log
    target that would capture a graph of its own)."""
    if capture.reads_back(getattr(fn, "uncaptured", fn), member):
        return "particles"
    if member.is_cuda and getattr(fn, "capturable", False):
        return "graph"
    return "vmap"


class Graphs:
    """``fn`` (a function of tensors returning a tuple of tensors) captured
    once per input shapes, dtype, device and Cholesky engine, and replayed."""

    def __init__(self, fn):
        self.fn, self._graphs = fn, {}

    def __call__(self, *inputs):
        global GRAPH_REPLAYS
        key = (tuple(tuple(t.shape) for t in inputs), inputs[0].dtype, inputs[0].device,
               get_chol_engine())
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = capture.Graph(self.fn, inputs, no_host_reads=True)
        GRAPH_REPLAYS += 1
        return graph(*inputs)


def _vmapped(crit, thetas):
    return (torch.func.vmap(crit)(thetas),)


class Criterion:
    """thetas (B, d) -> (J(theta_b))_b, (B,), for a criterion ``crit`` of one
    parameter vector, by the route ``route`` decides at the first call for
    each Cholesky engine; ``self.route`` is the route of the last call."""

    def __init__(self, crit):
        self.crit = crit
        self.route = None
        self._routes = {}
        self._graphs = Graphs(functools.partial(_vmapped, crit))

    def __call__(self, thetas):
        engine = get_chol_engine()
        if engine not in self._routes:
            self._routes[engine] = route(self.crit, thetas[0])
        self.route = self._routes[engine]
        with torch.no_grad():
            if self.route == "particles":
                return torch.stack([self.crit(t).reshape(()) for t in thetas])
            if self.route == "vmap":
                return torch.func.vmap(self.crit)(thetas)
            return self._graphs(thetas)[0]
