"""LeNet (counterpart of paddle_tpu/vision/models/lenet.py)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device

__all__ = ["LeNet"]


class LeNet(tnn.Module):
    def __init__(self, num_classes=10, device=None, generator=None):
        super().__init__()
        resolve_device(device)
        self.num_classes = num_classes
        with torch.device("meta"):
            self.features = nn.Sequential(
                nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
                nn.MaxPool2D(2, 2),
                nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
                nn.MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = nn.Sequential(nn.Linear(400, 120),
                                        nn.Linear(120, 84),
                                        nn.Linear(84, num_classes))
        adopt(self, device, generator)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
