"""Layers and helpers of the port (counterpart of paddle_tpu/nn): gradient
clipping, and the Mixture-of-Experts layer in ``nn.moe``."""
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_"]
