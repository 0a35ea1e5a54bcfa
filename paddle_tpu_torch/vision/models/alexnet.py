"""AlexNet (counterpart of paddle_tpu/vision/models/alexnet.py)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device

__all__ = ["AlexNet", "alexnet"]


class AlexNet(tnn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, device=None,
                 generator=None):
        super().__init__()
        resolve_device(device)
        with torch.device("meta"):
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
                nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
                nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
                nn.MaxPool2D(3, 2))
            self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
            self.classifier = nn.Sequential(
                nn.Dropout(dropout), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes))
            self.flatten = nn.Flatten()
        adopt(self, device, generator)

    def forward(self, x):
        x = self.flatten(self.avgpool(self.features(x)))
        return self.classifier(x)


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return AlexNet(**kwargs)
