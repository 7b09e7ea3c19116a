"""Device resolution for the port's entry points.

Counterpart: none in ``paddle_tpu`` (JAX picks its backend globally).
Every entry point of ``paddle_tpu_torch`` (``GPTForCausalLM``,
``ServingEngine``, ``BlockPool``) takes ``device=None`` and runs on the
CUDA card unless the caller asks for the CPU. Without a card, the
default fails loudly instead of falling back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises
    RuntimeError naming the ``device="cpu"`` opt-in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"paddle_tpu_torch: device {str(dev)!r} requested "
            f"{'(the default) ' if device is None else ''}but no CUDA GPU "
            "is available; pass device=\"cpu\" to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"paddle_tpu_torch runs on 'cuda' or 'cpu', got "
                         f"{str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
