"""Training-step wrapper (counterpart of paddle_tpu/jit's ``TrainStep``).

The reference traces the whole step into one compiled program. PyTorch runs
eagerly, so the port's ``TrainStep`` keeps the call contract and runs the
step on the model's device as written: the semantics the reference's
docstring promises, an eager step per call. A CUDA-graph capture of the
whole step is later work.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(step_fn, models, optimizers)``; ``loss =
    step(tokens, labels)``.

    ``step_fn`` runs ordinary eager code: forward, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``, and returns the loss. Arguments
    that are numpy arrays or tensors elsewhere are moved to the first
    model's device first. Each call must advance every optimizer's step
    count exactly once (one ``opt.step()``): a ``step_fn`` that steps an
    optimizer twice, or not at all, raises ``RuntimeError``. (The
    reference's ``TrainStep`` advances the count once itself and once more
    inside ``opt.step()``, so its Adam bias correction runs at t = 2, 4, 6,
    ...; the port follows the eager loop instead.)"""

    def __init__(self, fn, models, optimizers):
        self._fn = fn
        self._models = list(models) if isinstance(models, (list, tuple)) \
            else [models]
        self._opts = list(optimizers) if isinstance(optimizers,
                                                    (list, tuple)) \
            else [optimizers]
        self._device = next(self._models[0].parameters()).device

    def _to_device(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if isinstance(a, torch.Tensor):
            return a.to(self._device, non_blocking=True)
        return a

    def __call__(self, *args):
        before = [o._opt_step for o in self._opts]
        out = self._fn(*[self._to_device(a) for a in args])
        for o, s in zip(self._opts, before):
            if o._opt_step != s + 1:
                raise RuntimeError(
                    f"TrainStep: an optimizer's step count went from {s} to "
                    f"{o._opt_step} in one call; step_fn must call "
                    "opt.step() exactly once")
        return out
