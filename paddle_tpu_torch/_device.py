"""Device resolution for the port's entry points.

Counterpart: none in ``paddle_tpu`` (JAX picks its backend globally).
Every entry point of ``paddle_tpu_torch`` (``GPTForCausalLM``,
``ServingEngine``, ``BlockPool``, the layers) takes ``device=None`` and
runs on the current place (``core/place.py``): the CUDA card unless the
caller asks for the CPU, with ``device="cpu"`` or ``set_device("cpu")``.
Without a card, the default fails loudly instead of falling back to the
CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current place's device (``core.place.default_device``:
    ``cuda:0`` until ``set_device`` says otherwise); a CUDA device without
    a card raises RuntimeError naming the ``device="cpu"`` opt-in."""
    if device is None:
        from .core import place     # core/place.py imports this module
        return place.default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"paddle_tpu_torch: device {str(dev)!r} requested but no CUDA "
            "GPU is available; pass device=\"cpu\" to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"paddle_tpu_torch runs on 'cuda' or 'cpu', got "
                         f"{str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
