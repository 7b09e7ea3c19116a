"""Counterpart: ``paddle_tpu/optimizer/__init__.py``: the base
``Optimizer`` with ``L1Decay`` / ``L2Decay``, ``SGD``, ``Momentum``,
``Adam``, ``AdamW``, the ten others of ``optimizers.py`` (``Adamax`` …
``Rprop``) and the schedulers of ``lr``."""
from . import lr
from .optimizer import L1Decay, L2Decay, Optimizer
from .optimizers import (ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, LBFGS, Momentum, NAdam, RAdam, RMSProp, Rprop)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "L1Decay",
           "L2Decay", "LBFGS", "Lamb", "Momentum", "NAdam", "Optimizer",
           "RAdam", "RMSProp", "Rprop", "SGD", "lr"]
