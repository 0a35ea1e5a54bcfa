"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

A clip is a callable over ``[(param, grad)]`` pairs that returns new pairs,
which is how an optimizer's ``grad_clip`` applies it. A parameter with
``need_clip = False`` passes through untouched and, for the global norm,
uncounted. No clip reads a value back to the host (no ``.item()``, no
Python branch on a tensor), so a CUDA graph of the training step
captures it whole.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradByValue:
    """Every element clamped into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(-max if min is None else min)

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max)) if _clipped(p, g)
                else (p, g) for p, g in params_grads]


class ClipGradByNorm:
    """Each gradient scaled by ``min(1, clip_norm / max(||g||, 1e-12))``,
    its own 2-norm taken in its own dtype, as the reference does."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = torch.sqrt(torch.sum(torch.square(g)))
                g = g * torch.clamp(
                    self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / max(norm, 1e-6))``, where
    ``norm`` is the float32 2-norm over all of them."""

    def __init__(self, clip_norm=1.0, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
        factor = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-6),
                             max=1.0)
        return [(p, (g.float() * factor).to(g.dtype)) if _clipped(p, g)
                else (p, g) for p, g in params_grads]


def _dense_pairs(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [(p, p.grad.to_dense() if p.grad.is_sparse else p.grad)
            for p in parameters if p.grad is not None]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Clip the gradients of ``parameters`` in place by their global 2-norm
    (:class:`ClipGradByGlobalNorm`; a sparse gradient is made dense
    first). ``norm_type`` and ``error_if_nonfinite`` are accepted and
    ignored, as in the reference. Returns None."""
    pairs = _dense_pairs(parameters)
    for (p, _), (_, g) in zip(pairs, ClipGradByGlobalNorm(max_norm)(pairs)):
        p.grad = g


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients of ``parameters`` into ``[-clip_value,
    clip_value]`` in place (a sparse gradient is made dense first)."""
    pairs = _dense_pairs(parameters)
    for (p, _), (_, g) in zip(pairs, ClipGradByValue(clip_value)(pairs)):
        p.grad = g
