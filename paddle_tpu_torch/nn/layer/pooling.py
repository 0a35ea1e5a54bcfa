"""Pooling layers (counterpart of paddle_tpu/nn/layer/pooling.py), with
Paddle's signatures: each calls its function of ``nn.functional`` with
every argument it was built with, ``exclusive``, ``divisor_override``,
``data_format`` and ``return_mask`` included (the reference's layers drop
them; ROADMAP queue 3)."""
from __future__ import annotations

from torch import nn

from ..functional import pooling as P

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool2D"]


class _MaxPool(nn.Module):
    _n = 2
    _format = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format or self._format

    def forward(self, x):
        return P._max_pool(self._n, x, self.kernel_size, self.stride,
                           self.padding, self.return_mask, self.ceil_mode,
                           self.data_format)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, ceil_mode={self.ceil_mode}")


class MaxPool1D(_MaxPool):
    _n, _format = 1, "NCL"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         return_mask)


class MaxPool2D(_MaxPool):
    _n, _format = 2, "NCHW"


class MaxPool3D(_MaxPool):
    _n, _format = 3, "NCDHW"


class _AvgPool(nn.Module):
    _n = 2
    _format = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format=None,
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format or self._format

    def forward(self, x):
        return P._avg_pool(self._n, x, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode, self.exclusive,
                           self.divisor_override, self.data_format)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, exclusive={self.exclusive}")


class AvgPool1D(_AvgPool):
    _n, _format = 1, "NCL"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive)


class AvgPool2D(_AvgPool):
    _n, _format = 2, "NCHW"


class AvgPool3D(_AvgPool):
    _n, _format = 3, "NCDHW"


class AdaptiveAvgPool1D(nn.Module):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return P.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return P.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(nn.Module):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return P.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(nn.Module):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return P.adaptive_max_pool2d(x, self.output_size, self.return_mask)
