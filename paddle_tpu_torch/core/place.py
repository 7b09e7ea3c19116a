"""Places: where a new tensor is put.

Counterpart: ``paddle_tpu/core/place.py``. A place is a named view onto a
``torch.device``: ``CPUPlace`` the host, ``CUDAPlace(i)`` the i-th card
(``_device.resolve_device``, so a card that is not there raises instead
of falling back to the CPU). ``set_device`` / ``get_device`` set and read
the place of the tensors that the creation and random ops make; until
``set_device`` is called that is ``CUDAPlace(0)``, as every entry point
of the port defaults to the card.

The reference's ``TPUPlace`` (and ``CUDAPlace``, its alias for the
accelerator there) has no device here: ``TPUPlace``, ``XPUPlace`` and
``set_device("tpu")`` raise the reference's ``ValueError`` for an
unknown device, and never fall back to the CPU.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace",
           "Place", "TPUPlace", "XPUPlace", "default_device", "device_count",
           "get_device", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "place_of", "set_device"]


def _unknown(device) -> ValueError:
    return ValueError(f"unknown device {device!r}")


class Place:
    """Base place: (device_type, device_id)."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def get_device_id(self) -> int:
        return self.device_id

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def torch_device(self) -> torch.device:
        raise _unknown(self.device_type)


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self) -> torch.device:
        return resolve_device(f"cuda:{self.device_id}")


class CUDAPinnedPlace(CPUPlace):
    pass


class TPUPlace(Place):
    """No TPU here: constructing one raises."""

    device_type = "tpu"

    def __init__(self, device_id: int = 0):
        raise _unknown(f"tpu:{int(device_id)}")


class XPUPlace(TPUPlace):
    device_type = "xpu"

    def __init__(self, device_id: int = 0):
        raise _unknown(f"xpu:{int(device_id)}")


def CustomPlace(dev_type: str = "cpu", device_id: int = 0) -> Place:
    """The reference's custom device: ``"cpu"`` or a card (``"gpu"``,
    ``"cuda"``); anything else raises."""
    return _parse(f"{dev_type}:{int(device_id)}")


_CURRENT_PLACE = [None]


def _default_place() -> Place:
    if _CURRENT_PLACE[0] is None:
        _CURRENT_PLACE[0] = CUDAPlace(0)
    return _CURRENT_PLACE[0]


def default_device() -> torch.device:
    """The ``torch.device`` of the current place (raises when it is a card
    that is not there)."""
    return _default_place().torch_device()


def place_of(device: torch.device) -> Place:
    """The place of a ``torch.device``."""
    if device.type == "cuda":
        return CUDAPlace(0 if device.index is None else device.index)
    return CPUPlace(0)


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return place_of(device)
    if not isinstance(device, str):
        raise TypeError(f"device must be str or Place, got {type(device)}")
    name, _, idx = device.partition(":")
    idx = int(idx) if idx else 0
    name = name.lower()
    if name == "cpu":
        return CPUPlace(idx)
    if name in ("gpu", "cuda"):
        return CUDAPlace(idx)
    raise _unknown(device)


def get_device() -> str:
    p = _default_place()
    return "cpu" if p.device_type == "cpu" else f"{p.device_type}:{p.device_id}"


def set_device(device) -> Place:
    """``paddle.device.set_device``: ``"cpu"``, ``"gpu"``, ``"gpu:1"``,
    ``"cuda:0"`` or a Place. A card that is not there raises."""
    place = _parse(device)
    place.torch_device()            # a missing card raises here, not later
    _CURRENT_PLACE[0] = place
    return place


def is_compiled_with_cuda() -> bool:
    """True when a CUDA card is present."""
    return torch.cuda.is_available()


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()
