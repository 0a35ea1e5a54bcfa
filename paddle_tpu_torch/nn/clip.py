"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py; the global-norm
clip GPT pretraining uses).

A clip is a callable over ``[(param, grad)]`` pairs that returns new pairs,
which is how an optimizer's ``grad_clip`` applies it.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / max(norm, 1e-6))``, where
    ``norm`` is the float32 2-norm over all of them. A parameter with
    ``need_clip = False`` is neither counted nor scaled."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "need_clip", True)]
        if not grads:
            return params_grads
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
        factor = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-6),
                             max=1.0)
        return [(p, g) if g is None or not getattr(p, "need_clip", True)
                else (p, (g.float() * factor).to(g.dtype))
                for p, g in params_grads]
