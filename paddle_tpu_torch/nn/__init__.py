"""Layers and helpers of the port (counterpart of paddle_tpu/nn): gradient
clipping, and the Mixture-of-Experts layer in ``nn.moe``."""
from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm"]
