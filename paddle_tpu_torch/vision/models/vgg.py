"""VGG family (counterpart of paddle_tpu/vision/models/vgg.py)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False):
    layers, in_ch = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_ch, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_ch = v
    return nn.Sequential(*layers)


class VGG(tnn.Module):
    """``features`` (a ``Sequential``, or the name of a configuration, "A"
    to "E", built on the meta device here), the pool and the classifier."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 batch_norm=False, device=None, generator=None):
        super().__init__()
        resolve_device(device)
        self.with_pool, self.num_classes = with_pool, num_classes
        with torch.device("meta"):
            self.features = _make_layers(_CFGS[features], batch_norm) \
                if isinstance(features, str) else features
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, num_classes))
            self.flatten = nn.Flatten()
        adopt(self, device, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(self.flatten(x))
        return x


def _vgg(cfg, batch_norm, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return VGG(cfg, batch_norm=batch_norm, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
