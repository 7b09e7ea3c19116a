"""Tensor-health telemetry: the packed health vector.

Counterpart: ``paddle_tpu/profiler/numerics.py``, ``health_vector``
(:66-88), the one reduction ``amp.debugging.check_numerics`` reads. The
rest of that module (``NumericsMonitor``, ``graph_health``) is ROADMAP
A11 with the rest of ``profiler/``.
"""
from __future__ import annotations

import torch

__all__ = ["FIELDS", "HEALTH_WIDTH", "health_vector"]

HEALTH_WIDTH = 5
#: row layout of every health vector
FIELDS = ("nan", "inf", "max_abs", "l2", "underflow")

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def health_vector(x: torch.Tensor) -> torch.Tensor:
    """``[nan_count, inf_count, max_abs(finite), l2(finite),
    underflow_count]`` as one f32 tensor [5] on x's device, computed
    without a host read. NaN and Inf elements are left out of max-abs and
    L2; underflow (non-zero values below the dtype's smallest normal) is
    counted for fp16 and bf16 only."""
    xf = x.float()
    finite_mask = torch.isfinite(xf)
    finite = torch.where(finite_mask, xf, 0.0)
    n_nan = torch.isnan(xf).sum()
    n_inf = torch.isinf(xf).sum()
    max_abs = (finite.abs().amax() if finite.numel()
               else torch.zeros((), device=x.device))
    l2 = torch.sqrt((finite * finite).sum())
    if x.dtype in _LOW_PRECISION:
        tiny = torch.finfo(x.dtype).tiny
        under = ((xf != 0.0) & (xf.abs() < tiny) & finite_mask).sum()
    else:
        under = torch.zeros((), dtype=torch.int64, device=x.device)
    return torch.stack([n_nan.float(), n_inf.float(), max_abs.float(),
                        l2.float(), under.float()])
