"""The user's autograd API: ``paddle.autograd`` and ``paddle.grad``.

Counterpart: ``paddle_tpu/autograd_api.py``: the grad-mode scopes
(``no_grad``, ``enable_grad``, ``set_grad_enabled``, ``is_grad_enabled``,
:25-67), ``backward`` (:70), ``grad`` (:84-205) with ``create_graph``
(:207-413), ``PyLayer`` / ``PyLayerContext`` (:416-499) and the
functional transforms ``vjp``, ``jvp``, ``functional_jacobian`` and
``functional_hessian`` (:502-558). torch autograd is the tape
(``core/engine.py``); this module maps Paddle's surface onto it.

``grad`` keeps the reference's contract: the gradients of ``outputs``
with respect to ``inputs`` (leaves or intermediates), ``.grad`` left
untouched, ``retain_graph`` defaulting to ``create_graph``, and a
ValueError with the reference's message for an input that does not
require a gradient (``input i does not require grad (stop_gradient=
True)``) or that the outputs do not reach, unless ``allow_unused``
(then None). torch has no ``no_grad_vars``: for one call, a hook on each
such tensor replaces the cotangent that reaches it by zeros, and a walk
of the graph from the outputs, stopping at those tensors, decides which
inputs are still reached (an input reached only through them is
unreached, as in the reference, not zero).

``create_graph=True`` is torch's own double backward through every
registered op. The fused kernels (``kernels/``: flash attention, the
fused MLPs, projection-LN, LayerNorm, BatchNorm) are custom ops whose
backward is another custom op with no derivative of its own: the first
derivative comes back, and asking for a second through such an op raises
torch's RuntimeError naming the backward op
(``paddle_tpu_torch.fused_ln_bwd``, ...). The reference, in interpret
mode, already fails at the first ``paddle.grad(..., create_graph=True)``
through a Pallas kernel; neither package returns a silent zero.

``PyLayer`` runs over a ``torch.autograd.Function`` made once a PyLayer
class. ``forward(ctx, *args, **kwargs)`` and ``backward(ctx, *grads)``
see facades; ``ctx.saved_tensor()`` is a method, as Paddle's is; the
backward returns one gradient for each tensor argument, in order, which
is mapped onto torch's one-per-argument. ``mark_non_differentiable`` and
``set_materialize_grads`` are recorded and change nothing, as in the
reference. A PyLayer under ``create_graph=True`` raises the reference's
NotImplementedError (its backward has no replayable forward there).

The functional transforms run on torch autograd, not ``torch.func``:
``vjp`` and ``functional_jacobian`` are reverse mode and go through the
fused kernels; ``jvp`` is the double-vjp (J·v as the gradient of Jᵀu
with respect to u) and ``functional_hessian`` a double backward, so
through a fused kernel both raise naming its backward op, where the
reference's JAX forward mode of a custom_vjp raises too. (``torch.func``
forward mode would return a zero tangent there without a word.)
``jacobian`` and ``hessian`` keep the reference's NotImplementedError.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch

from .core import engine
from .core.tensor import Tensor, to_plain, wrap

__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad",
           "functional_hessian", "functional_jacobian", "grad", "hessian",
           "is_grad_enabled", "jacobian", "jvp", "no_grad",
           "set_grad_enabled", "vjp"]


def is_grad_enabled():
    return engine.is_grad_enabled()


def set_grad_enabled(mode: bool):
    return _GradScope(mode)


class _GradScope:
    """Context manager usable as decorator (paddle.no_grad parity)."""

    def __init__(self, mode):
        self.mode = mode
        self.prev = None

    def __enter__(self):
        self.prev = engine.is_grad_enabled()
        engine.set_grad_enabled(self.mode)
        return self

    def __exit__(self, *exc):
        engine.set_grad_enabled(self.prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with _GradScope(self.mode):
                return fn(*a, **kw)

        return wrapper


def no_grad(func=None):
    scope = _GradScope(False)
    return scope(func) if func is not None else scope


def enable_grad(func=None):
    scope = _GradScope(True)
    return scope(func) if func is not None else scope


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _seed(out, g):
    out = to_plain(out)
    if g is None:
        return torch.ones_like(out)
    g = to_plain(g) if isinstance(g, torch.Tensor) else torch.as_tensor(g)
    return g.to(device=out.device, dtype=out.dtype)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate into the leaves' ``.grad``."""
    tensors = _as_list(tensors)
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    torch.autograd.backward(tensors,
                            [_seed(t, g) for t, g in
                             zip(tensors, _as_list(grad_tensors))],
                            retain_graph=retain_graph)


# ---------------------------------------------------------------------------
# paddle.grad
# ---------------------------------------------------------------------------

def _key(t):
    """The graph slot that produces ``t``: (node, output index); a leaf's
    slot is its AccumulateGrad node (found through a view's edge)."""
    if t.grad_fn is not None:
        return t.grad_fn, t.output_nr
    return torch.Tensor.view_as(t, t).grad_fn.next_functions[0]


def _reached(outputs, inputs, cut):
    """Indices of ``inputs`` that the outputs reach without passing a
    slot of ``cut``: a walk of the autograd graph."""
    want = {}
    for i, t in enumerate(inputs):
        if t is not None:
            node, nr = _key(t)
            want.setdefault((id(node), nr), []).append(i)
    stops = {(id(n), nr) for n, nr in (_key(t) for t in cut)}
    reached, seen, keep = set(), set(), []
    stack = [_key(o) for o in outputs]
    while stack:
        node, nr = stack.pop()
        k = (id(node), nr)
        if node is None or k in seen or k in stops:
            continue
        seen.add(k)
        keep.append(node)           # ids stay unique while the walk lives
        reached.update(want.get(k, ()))
        stack.extend(e for e in node.next_functions if e[0] is not None)
    return reached


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs`` as a list (None for an unused input under
    ``allow_unused``), ``.grad`` untouched. See the module docstring."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    grad_outputs = _as_list(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    # the objects themselves: a facade's plain alias is another graph node
    live_in = [t if t.requires_grad else None for t in inputs]
    if create_graph and not allow_unused:
        for i, t in enumerate(live_in):
            if t is None and inputs[i].grad_fn is None:
                raise ValueError(
                    f"input {i} does not require grad (stop_gradient=True)")
    pairs = [(o, _seed(o, g)) for o, g in zip(outputs, grad_outputs)
             if o.requires_grad]
    cut = [t for t in (no_grad_vars or ()) if t.requires_grad]
    wanted = [t for t in live_in if t is not None]
    got: List[Optional[torch.Tensor]] = [None] * len(inputs)
    if pairs and wanted:
        handles = [torch.Tensor.register_hook(t, torch.zeros_like)
                   for t in cut]
        try:
            res = torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                retain_graph=retain_graph, create_graph=create_graph,
                allow_unused=True)
        finally:
            for h in handles:
                h.remove()
        it = iter(res)
        got = [None if t is None else next(it) for t in live_in]
        if cut:
            reached = _reached([o for o, _ in pairs], live_in, cut)
            got = [g if i in reached else None for i, g in enumerate(got)]
    missing = [i for i, g in enumerate(got) if g is None]
    if missing and not allow_unused:
        if create_graph:
            raise ValueError(
                f"input(s) {missing} are not reachable from the outputs; "
                "set allow_unused=True to get None for them (reference "
                "GeneralGrad semantics)")
        i = missing[0]
        if inputs[i].grad_fn is None and not inputs[i].requires_grad:
            raise ValueError(
                f"input {i} does not require grad (stop_gradient=True)")
        raise ValueError(
            f"input {i} is not reachable from the outputs; set "
            "allow_unused=True to get None for it")
    return [None if g is None else wrap(g) for g in got]


# ---------------------------------------------------------------------------
# PyLayer: user-defined forward/backward (py_layer.py:282 parity)
# ---------------------------------------------------------------------------

class PyLayerContext:
    def __init__(self):
        self.saved = []
        self.materialize_grads = True
        self._attrs = {}

    def save_for_backward(self, *tensors):
        self.saved = list(tensors)

    def saved_tensor(self):
        return self.saved

    def mark_not_inplace(self, *a):
        pass

    def mark_non_differentiable(self, *a):
        pass

    def set_materialize_grads(self, v):
        self.materialize_grads = v


def _facade(x):
    return x.as_subclass(Tensor) if type(x) is torch.Tensor else x


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    """User autograd function: ``forward`` / ``backward`` are written
    against facades; ``apply`` records the backward on torch's graph."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def _function(cls):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
                      {"forward": staticmethod(_pylayer_forward),
                       "backward": staticmethod(_pylayer_backward)})
            cls._torch_function = fn
        return fn

    @classmethod
    def apply(cls, *args, **kwargs):
        out = cls._function().apply(cls, kwargs, *args)
        if isinstance(out, tuple):
            return tuple(wrap(o) for o in out)
        return wrap(out)


def _pylayer_forward(tctx, cls, kwargs, *args):
    ctx = PyLayerContext()
    tctx.paddle_ctx = ctx
    tctx.layer = cls
    tctx.tensor_args = [i for i, a in enumerate(args)
                        if isinstance(a, torch.Tensor)]
    outs = cls.forward(ctx, *[_facade(a) for a in args], **kwargs)
    return tuple(outs) if isinstance(outs, list) else outs


def _pylayer_backward(tctx, *grads):
    if torch.is_grad_enabled():
        raise NotImplementedError(
            f"create_graph=True through '{tctx.layer.__name__}' is "
            "unsupported: the node records no replayable forward "
            "(PyLayer/custom grad nodes define only a backward). Express "
            "it via regular ops for higher-order grads.")
    res = tctx.layer.backward(tctx.paddle_ctx,
                              *[_facade(g) for g in grads])
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    full = [None] * (len(tctx.needs_input_grad) - 2)
    for pos, g in zip(tctx.tensor_args, res):
        full[pos] = g
    return (None, None, *full)


# ---------------------------------------------------------------------------
# Functional transforms over pure functions
# ---------------------------------------------------------------------------

def jacobian(ys, xs, batch_axis=None):
    raise NotImplementedError(
        "use paddle.incubate.autograd.jacobian(func, xs)")


def hessian(ys, xs, batch_axis=None):
    raise NotImplementedError(
        "use paddle.incubate.autograd.hessian(func, xs)")


def _primals(xs):
    """Fresh leaves (facades, requiring grad) holding the values of xs."""
    return [Tensor(to_plain(x).detach(), stop_gradient=False)
            for x in _as_list(xs)]


def _plain_fn(func):
    def pure(*vals):
        return to_plain(func(*[_facade(v) for v in vals]))
    return pure


def functional_jacobian(func, xs):
    vals = tuple(to_plain(x).detach() for x in _as_list(xs))
    jac = torch.autograd.functional.jacobian(_plain_fn(func), vals)
    if not isinstance(xs, (list, tuple)):
        return wrap(jac[0])
    return [wrap(j) for j in jac]


def functional_hessian(func, xs):
    vals = tuple(to_plain(x).detach() for x in _as_list(xs))
    hess = torch.autograd.functional.hessian(_plain_fn(func), vals)
    if not isinstance(xs, (list, tuple)):
        return wrap(hess[0][0])
    return hess


def vjp(func, xs, v=None):
    """(func(xs), vᵀ·J) by reverse mode; v None: ones."""
    prim = _primals(xs)
    with engine.enable_grad_guard():
        out = func(*prim)
    cot = _seed(out, v)
    grads = torch.autograd.grad(out, prim, cot, allow_unused=True)
    grads = [wrap(torch.zeros_like(to_plain(p)) if g is None else g)
             for p, g in zip(prim, grads)]
    out = wrap(torch.Tensor.detach(out))
    return out, grads if isinstance(xs, (list, tuple)) else grads[0]


def jvp(func, xs, v=None):
    """(func(xs), J·v) as the double-vjp: the gradient, with respect to a
    dummy cotangent u, of Jᵀu, seeded with v; v None: ones."""
    prim = _primals(xs)
    tangents = ([torch.ones_like(to_plain(p)) for p in prim] if v is None
                else [_seed(p, t) for p, t in zip(prim, _as_list(v))])
    with engine.enable_grad_guard():
        out = func(*prim)
        u = torch.zeros_like(to_plain(out), requires_grad=True)
        gs = torch.autograd.grad(out, prim, u, create_graph=True,
                                 allow_unused=True)
        live = [(g, t) for g, t in zip(gs, tangents)
                if g is not None and g.requires_grad]
        if live:
            (jv,) = torch.autograd.grad([g for g, _ in live], u,
                                        [t for _, t in live],
                                        allow_unused=True)
        else:
            jv = None
    out = torch.Tensor.detach(out)
    jv = torch.zeros_like(out) if jv is None else jv.detach()
    return wrap(out), wrap(jv)
