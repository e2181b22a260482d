# gpmp_tpu_torch/ops/autograd.py
"""Second-order rules of the port's custom autograd Functions.

A backward runs with grad mode on exactly when the caller asked for a
differentiable gradient (``create_graph=True``: ``torch.autograd.functional
.hessian``, a Hessian-vector product).  Two cases:

- the gram kernels (K1/K2, K1d, K1m) have a plain PyTorch composition of
  the same function: under ``create_graph`` their backward is that
  composition's VJP, recorded (``plain_vjp``), so a second derivative is
  exact; otherwise it stays on the kernels;
- every other Function has a first-order analytic rule only
  (``first_order_only``): its backward raises under ``create_graph``.
  ``once_differentiable`` is not enough: it marks the gradients only when
  the incoming cotangent requires grad and returns constants otherwise, so
  a Hessian through it came out silently zero.
"""

import functools

import torch


def plain_vjp(fn, inputs, need, cot, create_graph=True):
    """The VJP of ``fn(*inputs)`` against ``cot``, through ``fn``'s plain
    composition, recorded for differentiation by default (a backward run
    under create_graph).  ``need`` flags the inputs that get a cotangent
    (they require grad); the others get None, and so does the second slot
    of an input passed twice (``K(x, x)``), whose whole cotangent goes to
    its first slot."""
    uniq = []
    for t, w in zip(inputs, need):
        if w and all(t is not u for u in uniq):
            uniq.append(t)
    if not uniq:
        return [None] * len(inputs)
    with torch.enable_grad():
        out = fn(*inputs)
        grads = torch.autograd.grad(out, uniq, cot, create_graph=create_graph,
                                    allow_unused=True)
    res = []
    for t, w in zip(inputs, need):
        i = next((k for k, u in enumerate(uniq) if u is t), None) if w else None
        if i is None:
            res.append(None)
            continue
        g = grads[i]
        uniq[i] = None  # later slots of the same tensor get None
        res.append(torch.zeros_like(t) if g is None else g)
    return res


def first_order_only(name):
    """Decorator of a Function's backward without a second-order rule: it
    runs without a graph, and raises when asked for one (create_graph=True:
    a Hessian, a Hessian-vector product), naming ``name``.  No code of the
    port asks these Functions for a gradient with create_graph."""
    msg = (f"{name}: second derivatives are not implemented (its backward is a "
           "first-order analytic rule); call it without create_graph=True")

    def deco(backward):
        @functools.wraps(backward)
        def wrapper(ctx, *grads):
            if torch.is_grad_enabled():
                raise RuntimeError(msg)
            return backward(ctx, *grads)

        return wrapper

    return deco
