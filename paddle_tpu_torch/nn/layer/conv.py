"""Convolution layers (counterpart of paddle_tpu/nn/layer/conv.py).

Weights are ``[out, in / groups, *kernel]``, or ``[in, out / groups,
*kernel]`` for a transposed convolution: the reference's layouts and
torch's alike, so ``convert`` carries them as they are. Defaults:
``KaimingUniform`` over ``fan_in = in * prod(kernel) / groups`` and a bias
uniform in ``±1 / sqrt(fan_in)``. ``padding_mode`` other than ``"zeros"``
pads by ``F.pad``'s mode first, as Paddle does (the reference drops it;
ROADMAP queue 3).
"""
from __future__ import annotations

import math

from torch import nn

from ..functional import conv as C
from ..initializer import KaimingUniform, Uniform
from .layers import ParamLayer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(ParamLayer, nn.Module):
    def __init__(self, n, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        nn.Module.__init__(self)
        ks = C.ntuple(kernel_size, n)
        self._n, self._stride, self._padding = n, stride, padding
        self._dilation, self._groups = dilation, groups
        self._padding_mode, self._data_format = padding_mode, data_format
        self._transpose, self._output_padding = transpose, output_padding
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = ks
        shape = ([in_channels, out_channels // groups, *ks] if transpose
                 else [out_channels, in_channels // groups, *ks])
        fan_in = in_channels * math.prod(ks) // groups
        self.create_parameter("weight", shape, weight_attr,
                              default_initializer=KaimingUniform(
                                  fan_in=fan_in))
        bound = 1.0 / math.sqrt(fan_in)
        self.create_parameter("bias", [out_channels], bias_attr, is_bias=True,
                              default_initializer=Uniform(-bound, bound))

    def forward(self, x, output_size=None):
        if self._transpose:
            return C._conv_transpose_nd(
                self._n, x, self.weight, self.bias, self._stride,
                self._padding, self._output_padding, self._dilation,
                self._groups, self._data_format, output_size)
        return C._conv_nd(self._n, x, self.weight, self.bias, self._stride,
                          self._padding, self._dilation, self._groups,
                          self._data_format, self._padding_mode)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}, padding={self._padding}, "
                f"groups={self._groups}, data_format={self._data_format}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)
