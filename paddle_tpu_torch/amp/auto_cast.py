"""auto_cast / amp_guard / decorate.

Counterpart: ``paddle_tpu/amp/auto_cast.py``: the thread-local state
(:25-38), the per-op cast decision ``_amp_hook`` (:42-70), installed as
the dispatch AMP hook, ``auto_cast`` / ``amp_guard`` (:76-98),
``decorate`` / ``amp_decorate`` (:101-137), ``is_auto_cast_enabled`` and
``get_amp_dtype``.

The decision is the reference's, rule for rule: an op in the custom black
list, or (unless in the custom white list) of the black category or in
``BLACK_LIST``, runs in float32; else an op in the custom white list, of
the white category or in ``WHITE_LIST``, runs in the low dtype; else
(promote) the low dtype at O2 and no cast at O1. Only float32, float16
and bfloat16 arguments are cast. ``torch.autocast`` is not used: its op
lists are not Paddle's (it casts neither a convolution's weight nor a
BatchNorm's vectors as the reference does).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core import dispatch
from ..core import dtype as dtypes
from .amp_lists import BLACK_LIST, WHITE_LIST

__all__ = ["amp_decorate", "amp_guard", "auto_cast", "decorate",
           "get_amp_dtype", "is_auto_cast_enabled"]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = torch.bfloat16
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def _amp_target(opdef):
    """The dtype ``opdef``'s float arguments are cast to now, or None."""
    if not _state.enabled:
        return None
    name = opdef.name
    if name in _state.custom_black or (name not in _state.custom_white and (
            opdef.amp == "black" or name in BLACK_LIST)):
        return torch.float32
    if (name in _state.custom_white or opdef.amp == "white"
            or name in WHITE_LIST):
        return _state.dtype
    return _state.dtype if _state.level == "O2" else None


_CASTABLE = (torch.float32, torch.float16, torch.bfloat16)


def _cast(v, target):
    if isinstance(v, torch.Tensor):
        return v.to(target) if v.dtype in _CASTABLE and v.dtype != target \
            else v
    if isinstance(v, (list, tuple)):
        out = [_cast(x, target) for x in v]
        if isinstance(v, list):
            return out
        return type(v)(*out) if hasattr(v, "_fields") else type(v)(out)
    if isinstance(v, dict):
        return {k: _cast(x, target) for k, x in v.items()}
    return v


def _amp_hook(opdef, args, kwargs):
    """The dispatch AMP hook: ``args`` and ``kwargs`` with every castable
    float tensor in the op's target dtype (unchanged with AMP off)."""
    if not _state.enabled:
        return args, kwargs
    target = _amp_target(opdef)
    if target is None:
        return args, kwargs
    return (tuple(_cast(a, target) for a in args),
            {k: _cast(v, target) for k, v in kwargs.items()})


dispatch.set_amp_hook(_amp_hook, _amp_target)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Paddle's ``amp.auto_cast``: the registered ops dispatched in the
    block follow the cast decision at ``level`` ('O0' turns AMP off) and
    low ``dtype`` ('bfloat16' by default, or 'float16')."""
    prev = (_state.enabled, _state.level, _state.dtype, _state.custom_white,
            _state.custom_black)
    _state.enabled = bool(enable)
    _state.level = level if level in ("O0", "O1", "O2") else "O1"
    if level == "O0":
        _state.enabled = False
    _state.dtype = dtypes.convert_dtype(dtype)
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.level, _state.dtype, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """Paddle's ``amp.decorate``: at O2 the float32 parameters of every
    module but the BatchNorm and LayerNorm layers (and the classes in
    ``excluded_layers``) become ``dtype`` in place (the Parameter objects
    stay, so optimizers and tied weights follow), and the optimizers keep
    float32 master weights (``_multi_precision``), as they do at any level
    with ``master_weight``."""
    from ..nn.layer.norm import LayerNorm, _BatchNormBase
    from ..optimizer import Optimizer

    single_model = isinstance(models, torch.nn.Module)
    model_list = [models] if single_model else list(models or [])
    if level == "O2":
        low = dtypes.convert_dtype(dtype)
        keep = (_BatchNormBase, LayerNorm) + tuple(
            e for e in (excluded_layers or []) if isinstance(e, type))
        with torch.no_grad():
            for m in model_list:
                for layer in m.modules():
                    if isinstance(layer, keep):
                        continue
                    for p in layer._parameters.values():
                        if p is not None and p.dtype == torch.float32:
                            p.data = p.data.to(low)
                m._casted_by_pure_fp16 = True
    if optimizers is None:
        return models if single_model else model_list
    single_opt = isinstance(optimizers, Optimizer)
    opt_list = [optimizers] if single_opt else list(optimizers)
    if level == "O2" or master_weight:
        for o in opt_list:
            o._multi_precision = True
    return (models if single_model else model_list,
            optimizers if single_opt else opt_list)


amp_decorate = decorate


def is_auto_cast_enabled():
    return _state.enabled


def get_amp_dtype():
    return dtypes.dtype_name(_state.dtype) if _state.enabled else "float32"
