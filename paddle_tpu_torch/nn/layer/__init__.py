"""Counterpart: ``paddle_tpu/nn/layer/__init__.py``: the ``Layer`` base
and its containers, and every layer module's classes."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extra import *  # noqa: F401,F403
from .layers import (HookRemoveHelper, Layer, LayerDict, LayerList,
                     ParameterList, Sequential)
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
from . import (activation, common, conv, extra, layers, loss, norm, pooling,
               rnn, transformer)

__all__ = sorted(
    ["HookRemoveHelper", "Layer", "LayerDict", "LayerList", "ParameterList",
     "Sequential"]
    + activation.__all__ + common.__all__ + conv.__all__ + extra.__all__
    + loss.__all__ + norm.__all__ + pooling.__all__ + rnn.__all__
    + transformer.__all__)
