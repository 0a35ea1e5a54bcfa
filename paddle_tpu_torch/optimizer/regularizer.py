"""Regularizers (counterpart of paddle_tpu/optimizer/regularizer.py).

A regularizer adds ``coeff * f(param)`` to the gradient before the clip
and the update: ``f(w) = w`` for :class:`L2Decay`, ``sign(w)`` for
:class:`L1Decay`. An optimizer's float ``weight_decay`` becomes an
``L2Decay``. A parameter's own ``regularizer`` attribute, where set,
replaces the optimizer's for that parameter, as in the reference.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class _Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __call__(self, param, grad):
        reg = getattr(param, "regularizer", None)
        if reg is not None and reg is not self:
            return reg._apply(param, grad) if isinstance(reg, _Decay) \
                else reg(param, grad)
        return self._apply(param, grad)


class L2Decay(_Decay):
    def _apply(self, param, grad):
        return grad + self._coeff * param.detach().to(grad.dtype)


class L1Decay(_Decay):
    def _apply(self, param, grad):
        return grad + self._coeff * torch.sign(param.detach()).to(grad.dtype)
