"""The op registry: the one path every registered functional goes through.

Counterpart: ``paddle_tpu/core/dispatch.py``: the hook slots (:28-70),
the dispatch statistics ``dispatch_stats`` / ``reset_dispatch_stats``
(:85-124), ``OpDef``, ``OP_REGISTRY`` and ``register_op`` (:139-180) and
``apply`` (:208-260): the call is counted, facade tensors
(``core/tensor.py``) among the arguments become plain tensors, the AMP
hook casts the arguments (:239), the body runs, the output hook sees the
outputs, and they are wrapped back as facades when an argument was one
(``_wrap_outputs``, :568).

The reference records a tape with ``jax.vjp`` and caches eager-jitted
programs; here torch autograd is the tape, so none of that is ported (nor
the static-graph and symbolic hooks, A9). With ``FLAGS_check_nan_inf``
on, the outputs go to the nan/inf check hook (:49-58) that
``amp/debugging.py`` installs, which counts bad values on the device and
reads once a window; without a hook each floating output is read on its
own and a bad one raises FloatingPointError (:570-587). A cast is
``tensor.to(dtype)``, which autograd differentiates: the gradient flows
back through it into the parameter's own dtype, as the reference's cast
vjp does. The AMP hook
casts every floating tensor among the positional and keyword arguments,
lists, tuples and dicts included, as the reference's tree flattening does
(``amp/auto_cast.py`` installs it); with AMP off it costs one
thread-local check. An op registered ``differentiable=False`` runs under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import flags as _flags
from .tensor import Tensor, plain_args

__all__ = ["OP_REGISTRY", "OpDef", "amp_dtypes", "apply", "dispatch_stats",
           "register_op", "reset_dispatch_stats", "set_amp_hook",
           "set_nan_check_hook", "set_output_hook"]

# The AMP hook, installed by paddle_tpu_torch.amp: (opdef, args, kwargs) ->
# (args, kwargs); and the decision it applies, (opdef) -> the dtype every
# float32 / float16 / bfloat16 argument is cast to, or None (no cast).
_amp_hook: Optional[Callable] = None
_amp_target: Optional[Callable] = None


def set_amp_hook(fn, target=None):
    global _amp_hook, _amp_target
    _amp_hook, _amp_target = fn, target


# Post-output observer, installed while amp.debugging.collect_operator_stats
# runs: (op_name, outputs as a list); it must not mutate them.
_output_hook: Optional[Callable] = None


def set_output_hook(fn):
    global _output_hook
    _output_hook = fn


# The batched nan/inf checker, installed by paddle_tpu_torch.amp.debugging:
# (op_name, outputs as a list). While FLAGS_check_nan_inf is on it takes
# the place of the per-tensor read below.
_nan_check_hook: Optional[Callable] = None


def set_nan_check_hook(fn):
    global _nan_check_hook
    _nan_check_hook = fn


def _check_nan_inf(name, outs):
    if _nan_check_hook is not None:
        _nan_check_hook(name, outs)
        return
    for v in outs:
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            bad = int(v.numel() - torch.isfinite(v).sum())
            if bad:
                raise FloatingPointError(
                    f"Operator {name} output contains {bad} NaN/Inf values "
                    f"(FLAGS_check_nan_inf is set)")


# calls per op name, always on (a dict lookup and an increment a call)
_DISPATCH_COUNTS: Dict[str, list] = {}


def dispatch_stats() -> dict:
    """The calls dispatched, in all and per op name."""
    return {"ops_dispatched": sum(c[0] for c in _DISPATCH_COUNTS.values()),
            "per_op": {name: {"calls": c[0]}
                       for name, c in sorted(_DISPATCH_COUNTS.items())}}


def reset_dispatch_stats() -> None:
    _DISPATCH_COUNTS.clear()


class OpDef:
    """One operator: its name, body, AMP category ('white': the low
    dtype; 'black': float32; 'promote': the low dtype at O2, no cast at
    O1), whether it returns several outputs and whether autograd records
    it."""

    __slots__ = ("name", "fn", "amp", "multi_out", "differentiable", "doc")

    def __init__(self, name: str, fn: Callable, amp: str = "promote",
                 multi_out: bool = False, differentiable: bool = True,
                 doc: str = ""):
        if amp not in ("white", "black", "promote"):
            raise ValueError(f"op {name}: amp category {amp!r} is 'white', "
                             f"'black' or 'promote'")
        self.name = name
        self.fn = fn
        self.amp = amp
        self.multi_out = multi_out
        self.differentiable = differentiable
        self.doc = doc


OP_REGISTRY: Dict[str, OpDef] = {}


def register_op(name: str, amp: str = "promote", multi_out: bool = False,
                differentiable: bool = True):
    """Decorator: register ``fn`` as operator ``name`` and return the
    dispatching callable (its ``opdef`` and ``__wrapped__`` attached)."""

    def deco(fn):
        opdef = OpDef(name, fn, amp=amp, multi_out=multi_out,
                      differentiable=differentiable, doc=fn.__doc__ or "")
        OP_REGISTRY[name] = opdef

        def dispatcher(*args, **kwargs):
            return apply(opdef, *args, **kwargs)

        dispatcher.__name__ = fn.__name__
        dispatcher.__qualname__ = fn.__qualname__
        dispatcher.__module__ = fn.__module__
        dispatcher.__doc__ = fn.__doc__
        dispatcher.__wrapped__ = fn
        dispatcher.opdef = opdef
        return dispatcher

    return deco


def _facade(o, given):
    """An op's plain output as a facade: a tensor the op made becomes one
    itself (its class is set, no alias node on the autograd graph); one
    the caller passed in is aliased instead."""
    if type(o) is not torch.Tensor:
        return o
    if any(o is a for a in given):
        return o.as_subclass(Tensor)
    o.__class__ = Tensor
    return o


def _wrap(out, args, kwargs):
    given = [*args, *kwargs.values()]
    t = type(out)
    if t is tuple or t is list:
        return t(_facade(o, given) for o in out)
    return _facade(out, given)


def apply(opdef: OpDef, *args, **kwargs):
    """Run one op: count the call, unwrap facade arguments, cast the
    arguments by the AMP hook, run the body, show the outputs to the output
    hook, and wrap them as facades when an argument was one."""
    kwargs.pop("name", None)   # Paddle's APIs thread a cosmetic name=
    given = args, kwargs
    plain = plain_args(args)
    facade = plain is not None
    if facade:
        args = plain
    if kwargs:
        vals = plain_args(kwargs.values())
        if vals is not None:
            facade = True
            kwargs = dict(zip(kwargs, vals))
    c = _DISPATCH_COUNTS.get(opdef.name)
    if c is None:
        c = _DISPATCH_COUNTS[opdef.name] = [0]
    c[0] += 1
    if _amp_hook is not None:
        args, kwargs = _amp_hook(opdef, args, kwargs)
    if opdef.differentiable:
        out = opdef.fn(*args, **kwargs)
    else:
        with torch.no_grad():
            out = opdef.fn(*args, **kwargs)
    check = _flags.get_flag("check_nan_inf")
    if _output_hook is not None or check:
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if _output_hook is not None:
            _output_hook(opdef.name, outs)
        if check:
            _check_nan_inf(opdef.name, outs)
    return _wrap(out, *given) if facade else out


_AMP_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def amp_dtypes(op, *tensors):
    """The dtypes ``tensors`` would have inside ``op`` (a registered
    dispatcher or its OpDef) after the AMP hook's cast: what a routing
    function checks a kernel's dtypes against before it calls the op."""
    target = None if _amp_target is None else _amp_target(
        getattr(op, "opdef", op))
    return [t.dtype if target is None or t.dtype not in _AMP_DTYPES
            else target for t in tensors]
