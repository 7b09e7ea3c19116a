"""Counterpart: ``paddle_tpu/nn/__init__.py``: the layers of
``layer/``, the ``Layer`` base and its containers, ``functional``,
``initializer`` (its five classes the reference's namespace carries too),
``utils``, the gradient clipping of ``clip.py`` and ``Parameter``.
Names that wait for a later item stand here and raise naming it when
used (``_not_ported.py``): ROADMAP A11's convolutions and pools, A10's
``SyncBatchNorm``."""

from ..core.tensor import Parameter
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from . import functional
from . import functional as F
from . import initializer, utils
from .initializer import (Constant, KaimingUniform, Normal, Uniform,
                          XavierNormal)
from .functional import tanh_act
from .layer import *  # noqa: F401,F403
from . import layer
from .layer.extra import dynamic_decode

__all__ = sorted(
    ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "Constant",
     "F", "KaimingUniform", "Normal", "Parameter", "Uniform", "XavierNormal",
     "clip_grad_norm_", "clip_grad_value_", "dynamic_decode", "functional",
     "initializer", "tanh_act", "utils"] + layer.__all__)
