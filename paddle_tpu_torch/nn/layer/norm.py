"""LayerNorm with the reference's signature (counterpart of the LayerNorm of
paddle_tpu/nn/layer/norm.py). The other normalisation layers belong to the
vision path (ROADMAP queue 1)."""
from __future__ import annotations

from torch import nn

from ..initializer import Constant
from .layers import ParamLayer

__all__ = ["LayerNorm"]


class LayerNorm(ParamLayer, nn.LayerNorm):
    """Normalises the trailing ``normalized_shape`` dimensions with
    ``epsilon``; scale ones and shift zeros by default, either left out
    when its attr is False. Subclasses torch's, whose forward it uses."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        nn.Module.__init__(self)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = tuple(normalized_shape)
        self.eps = epsilon
        self.elementwise_affine = weight_attr is not False
        self.create_parameter("weight", self.normalized_shape, weight_attr,
                              default_initializer=Constant(1.0))
        self.create_parameter("bias", self.normalized_shape, bias_attr,
                              is_bias=True)
