"""Layers and helpers of the port (counterpart of paddle_tpu/nn): gradient
clipping so far."""
from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm"]
