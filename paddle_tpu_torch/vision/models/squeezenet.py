"""SqueezeNet (counterpart of paddle_tpu/vision/models/squeezenet.py)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(tnn.Module):
    def __init__(self, in_ch, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(in_ch, squeeze, 1), nn.ReLU())
        self.expand1 = nn.Sequential(nn.Conv2D(squeeze, expand1x1, 1),
                                     nn.ReLU())
        self.expand3 = nn.Sequential(
            nn.Conv2D(squeeze, expand3x3, 3, padding=1), nn.ReLU())

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1(x), self.expand3(x)], 1)


class SqueezeNet(tnn.Module):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        resolve_device(device)
        self.num_classes, self.with_pool = num_classes, with_pool
        with torch.device("meta"):
            if version == "1.0":
                self.features = nn.Sequential(
                    nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                    nn.MaxPool2D(3, 2),
                    _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                    _Fire(128, 32, 128, 128),
                    nn.MaxPool2D(3, 2),
                    _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                    _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                    nn.MaxPool2D(3, 2),
                    _Fire(512, 64, 256, 256))
            else:
                self.features = nn.Sequential(
                    nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                    nn.MaxPool2D(3, 2),
                    _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                    nn.MaxPool2D(3, 2),
                    _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                    nn.MaxPool2D(3, 2),
                    _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                    _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1),
                    nn.ReLU())
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            self.flatten = nn.Flatten()
        adopt(self, device, generator)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return self.flatten(x)


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return SqueezeNet("1.1", **kwargs)
