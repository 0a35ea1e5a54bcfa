"""Inception v3 (counterpart of paddle_tpu/vision/models/inceptionv3.py):
factorised 7x1 / 1x7 and 3x1 / 1x3 convolution branches."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device
from .googlenet import _ConvBN

__all__ = ["InceptionV3", "inception_v3"]


class _InceptionA(tnn.Module):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 64, 1)
        self.b5 = nn.Sequential(_ConvBN(in_ch, 48, 1),
                                _ConvBN(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_ConvBN(in_ch, 64, 1),
                                _ConvBN(64, 96, 3, padding=1),
                                _ConvBN(96, 96, 3, padding=1))
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.bp = _ConvBN(in_ch, pool_features, 1)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x),
                          self.bp(self.pool(x))], 1)


class _ReductionA(tnn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = _ConvBN(in_ch, 384, 3, stride=2)
        self.b3d = nn.Sequential(_ConvBN(in_ch, 64, 1),
                                 _ConvBN(64, 96, 3, padding=1),
                                 _ConvBN(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], 1)


class _InceptionB(tnn.Module):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 192, 1)
        self.b7 = nn.Sequential(
            _ConvBN(in_ch, c7, 1),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _ConvBN(in_ch, c7, 1),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, 192, (1, 7), padding=(0, 3)))
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.bp = _ConvBN(in_ch, 192, 1)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x),
                          self.bp(self.pool(x))], 1)


class _ReductionB(tnn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBN(in_ch, 192, 1),
                                _ConvBN(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _ConvBN(in_ch, 192, 1),
            _ConvBN(192, 192, (1, 7), padding=(0, 3)),
            _ConvBN(192, 192, (7, 1), padding=(3, 0)),
            _ConvBN(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], 1)


class _InceptionC(tnn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 320, 1)
        self.b3_stem = _ConvBN(in_ch, 384, 1)
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_ConvBN(in_ch, 448, 1),
                                      _ConvBN(448, 384, 3, padding=1))
        self.b3d_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.bp = _ConvBN(in_ch, 192, 1)

    def forward(self, x):
        s, d = self.b3_stem(x), self.b3d_stem(x)
        return torch.cat([self.b1(x), self.b3_a(s), self.b3_b(s),
                          self.b3d_a(d), self.b3d_b(d),
                          self.bp(self.pool(x))], 1)


class InceptionV3(tnn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 generator=None):
        super().__init__()
        resolve_device(device)
        self.num_classes, self.with_pool = num_classes, with_pool
        with torch.device("meta"):
            self.stem = nn.Sequential(
                _ConvBN(3, 32, 3, stride=2), _ConvBN(32, 32, 3),
                _ConvBN(32, 64, 3, padding=1), nn.MaxPool2D(3, stride=2),
                _ConvBN(64, 80, 1), _ConvBN(80, 192, 3),
                nn.MaxPool2D(3, stride=2))
            self.blocks = nn.Sequential(
                _InceptionA(192, 32), _InceptionA(256, 64),
                _InceptionA(288, 64), _ReductionA(288),
                _InceptionB(768, 128), _InceptionB(768, 160),
                _InceptionB(768, 160), _InceptionB(768, 192),
                _ReductionB(768), _InceptionC(1280), _InceptionC(2048))
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            self.dropout = nn.Dropout(0.5)
            if num_classes > 0:
                self.fc = nn.Linear(2048, num_classes)
        adopt(self, device, generator)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(torch.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled in this build")
    return InceptionV3(**kwargs)
