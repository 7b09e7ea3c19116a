"""GradScaler: dynamic loss scaling.

Counterpart: ``paddle_tpu/amp/grad_scaler.py``: ``OptiLevel``,
``AmpScaler`` (:27-203) and ``GradScaler`` (:206-217): ``scale``,
``unscale_``, ``step``, which skips the optimizer's update when an
unscaled gradient is inf or nan (parameters, accumulators and master
weights stay as they were), ``update`` (the dynamic scale: ×decr_ratio,
at least 1, after ``decr_every_n_nan_or_inf`` bad steps; ×incr_ratio
after ``incr_every_n_steps`` good ones; every call advances the tensor
checker's step count, ``amp.debugging.advance_step``), ``minimize`` and
``state_dict`` / ``load_state_dict``. ``step`` reads the scaler's state
from the device once, packed (``_telemetry_read``). The state tensors
live on the device of the first loss scaled.

Not ported: the flight-recorder records (ROADMAP A7) and the traced
(``to_static``) step, which selects the skip inside the compiled program
(A9).
"""
from __future__ import annotations

from enum import Enum

import numpy as np
import torch

__all__ = ["AmpScaler", "GradScaler", "OptiLevel"]


class OptiLevel(Enum):
    O0 = 0
    O1 = 1
    O2 = 2


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = torch.tensor(0, dtype=torch.int32)
        self._bad_steps = torch.tensor(0, dtype=torch.int32)
        self._found_inf = torch.tensor(False)
        self._already_unscaled = False

    def _to(self, device):
        if self._scale.device != device:
            self._scale, self._good_steps, self._bad_steps, \
                self._found_inf = (t.to(device) for t in (
                    self._scale, self._good_steps, self._bad_steps,
                    self._found_inf))

    def scale(self, var):
        """var × the loss scale (a 16-bit var in f32, as the reference's
        multiply by an f32 scale promotes it)."""
        if not self._enable:
            return var
        self._to(var.device)
        if var.dtype in (torch.float16, torch.bfloat16):
            var = var.float()
        return var * self._scale

    def minimize(self, optimizer, *args, **kwargs):
        self.step(optimizer)
        self.update()

    def _telemetry_read(self):
        """One packed host read of (found_inf, scale, good, bad)."""
        packed = torch.stack([self._found_inf.float(), self._scale.float(),
                              self._good_steps.float(),
                              self._bad_steps.float()]).tolist()
        return (bool(packed[0]), packed[1], int(packed[2]), int(packed[3]))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._already_unscaled:
            self._already_unscaled = False   # unscale_ ran for clipping
        else:
            self._unscale(optimizer)
        found, _, _, _ = self._telemetry_read()
        if not found:
            optimizer.step()
        # else: the update is skipped (the reference's semantics)

    @torch.no_grad()
    def _unscale(self, optimizer):
        """Every gradient × 1 / scale in f32, cast back to its dtype, in
        place; found_inf: any unscaled gradient not finite."""
        inv = None
        found = None
        for p in optimizer._parameter_list:
            g = p.grad
            if g is None:
                continue
            if inv is None:
                self._to(g.device)
                inv = 1.0 / self._scale
                found = torch.zeros((), dtype=torch.bool, device=g.device)
            v = g.float() * inv
            found |= ~torch.isfinite(v).all()
            g.copy_(v)
        self._found_inf = (torch.zeros((), dtype=torch.bool,
                                       device=self._scale.device)
                           if found is None else found)

    def update(self):
        from . import debugging
        debugging.advance_step()    # TensorCheckerConfig.debug_step's count
        if not (self._enable and self._dynamic):
            return
        found = self._found_inf
        new_bad = torch.where(found, self._bad_steps + 1, 0).int()
        new_good = torch.where(found, 0, self._good_steps + 1).int()
        dec = new_bad >= self._decr_every_n
        inc = new_good >= self._incr_every_n_steps
        scale = self._scale
        self._scale = torch.where(
            dec, torch.clamp_min(scale * self._decr_ratio, 1.0),
            torch.where(inc, scale * self._incr_ratio, scale))
        self._bad_steps = torch.where(dec, 0, new_bad).int()
        self._good_steps = torch.where(inc, 0, new_good).int()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return float(self._scale)

    def set_init_loss_scaling(self, v):
        self._scale = torch.tensor(float(v), dtype=torch.float32,
                                   device=self._scale.device)

    def state_dict(self):
        return {
            "scale": np.asarray(self._scale.cpu().numpy()),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "good_steps": int(self._good_steps),
            "bad_steps": int(self._bad_steps),
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, sd):
        dev = self._scale.device
        self._scale = torch.tensor(np.asarray(sd["scale"], np.float32),
                                   device=dev)
        self._incr_ratio = sd["incr_ratio"]
        self._decr_ratio = sd["decr_ratio"]
        self._incr_every_n_steps = sd["incr_every_n_steps"]
        self._decr_every_n = sd["decr_every_n_nan_or_inf"]
        self._good_steps = torch.tensor(int(sd["good_steps"]),
                                        dtype=torch.int32, device=dev)
        self._bad_steps = torch.tensor(int(sd["bad_steps"]),
                                       dtype=torch.int32, device=dev)
        self._dynamic = sd["use_dynamic_loss_scaling"]


class GradScaler(AmpScaler):
    """Paddle's public scaler: scale → backward → step → update."""

    def unscale_(self, optimizer):
        """Unscale the gradients now (to clip them), so that ``step`` does
        not divide a second time; a disabled scaler does nothing."""
        if not self._enable:
            return
        self._unscale(optimizer)
        self._already_unscaled = True
