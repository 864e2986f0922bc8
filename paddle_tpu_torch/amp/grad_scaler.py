"""``GradScaler``: dynamic loss scaling with the found-inf skip, port of
``paddle_tpu/amp/grad_scaler.py``.

``unscale_`` multiplies every gradient of the optimizer's parameters by
``1 / scale`` in float32, writes it back in the gradient's dtype and
notes whether any element is not finite (one host read for all of
them); ``step`` then skips the update, and ``update`` runs the
incr/decr schedule: ``decr_every_n_nan_or_inf`` bad steps in a row
multiply the scale by ``decr_ratio`` (never below 1), and
``incr_every_n_steps`` good steps in a row by ``incr_ratio``.
"""

from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            n = (~torch.isfinite(g)).any()
            bad = n if bad is None else bad | n
            p.grad.copy_(g)
        self._found_inf = bool(bad) if bad is not None else False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not (self._enable and self._use_dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, value):
        self._scale = float(value)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


AmpScaler = GradScaler
