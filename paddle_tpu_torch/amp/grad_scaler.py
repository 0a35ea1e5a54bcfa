"""GradScaler: dynamic loss scaling (counterpart of
paddle_tpu/amp/grad_scaler.py).

float16 needs it (its exponent range is bf16's minus three bits); bf16 runs
it as a pass-through at most. The scaler is eager, as in the reference:
``unscale_`` reduces every gradient to one all-finite flag on the device
and reads it on the host once per step (``bool(found)``), and ``step``
branches on it in Python. A step that reads the host cannot be captured
as a CUDA graph, so ``jit.TrainStep`` refuses a ``step_fn`` that calls
``scaler.step`` (its first, eager call raises before anything is
captured); the reference's ``bool(found_traced)`` cannot be traced either.
"""
from __future__ import annotations

import torch

__all__ = ["AmpScaler", "GradScaler"]


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        """``var`` times the loss scale (``var`` itself when disabled)."""
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer`` by the scale in float32 and
        store it back in its own dtype (a sparse gradient made dense first),
        then set ``_found_inf`` from one all-finite reduction over all of
        them: one host read per step."""
        if not self._enable:
            return
        found = None
        for p in optimizer._parameter_list:
            if p is None or p.grad is None:
                continue
            g = p.grad.to_dense() if p.grad.is_sparse else p.grad
            unscaled = g.float() / self._scale
            p.grad = unscaled.to(g.dtype)
            bad = ~torch.isfinite(unscaled).all()
            found = bad if found is None else found | bad
        self._found_inf = bool(found) if found is not None else False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        """Unscale, then ``optimizer.step()`` unless a gradient is not
        finite (the update is skipped)."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        """Adjust the scale: times ``decr_ratio`` (at least 1) after
        ``decr_every_n_nan_or_inf`` skipped steps, times ``incr_ratio`` after
        ``incr_every_n_steps`` good ones."""
        if not (self._enable and self._dynamic):
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

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)


class GradScaler(AmpScaler):
    """The public class (``paddle.amp.GradScaler``)."""
