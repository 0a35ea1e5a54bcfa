"""GoogLeNet / Inception v1 (counterpart of
paddle_tpu/vision/models/googlenet.py): parallel 1x1, 3x3, 5x5 and pool
branches concatenated. Returns the main and the two auxiliary logits."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device

__all__ = ["GoogLeNet", "googlenet"]


class _ConvBN(tnn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _Inception(tnn.Module):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _ConvBN(in_ch, c1, 1)
        self.b2 = nn.Sequential(_ConvBN(in_ch, c3r, 1),
                                _ConvBN(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_ConvBN(in_ch, c5r, 1),
                                _ConvBN(c5r, c5, 5, padding=2))
        self.b4_pool = nn.MaxPool2D(3, stride=1, padding=1)
        self.b4 = _ConvBN(in_ch, proj, 1)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x),
                          self.b4(self.b4_pool(x))], 1)


class _AuxHead(tnn.Module):
    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = _ConvBN(in_ch, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = self.relu(self.fc1(torch.flatten(x, 1)))
        return self.fc2(self.dropout(x))


class GoogLeNet(tnn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 generator=None):
        super().__init__()
        resolve_device(device)
        self.num_classes, self.with_pool = num_classes, with_pool
        with torch.device("meta"):
            self.stem = nn.Sequential(
                _ConvBN(3, 64, 7, stride=2, padding=3),
                nn.MaxPool2D(3, stride=2, padding=1),
                _ConvBN(64, 64, 1),
                _ConvBN(64, 192, 3, padding=1),
                nn.MaxPool2D(3, stride=2, padding=1))
            self.inc3a = _Inception(192, 64, 96, 128, 16, 32, 32)
            self.inc3b = _Inception(256, 128, 128, 192, 32, 96, 64)
            self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
            self.inc4a = _Inception(480, 192, 96, 208, 16, 48, 64)
            self.inc4b = _Inception(512, 160, 112, 224, 24, 64, 64)
            self.inc4c = _Inception(512, 128, 128, 256, 24, 64, 64)
            self.inc4d = _Inception(512, 112, 144, 288, 32, 64, 64)
            self.inc4e = _Inception(528, 256, 160, 320, 32, 128, 128)
            self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
            self.inc5a = _Inception(832, 256, 160, 320, 32, 128, 128)
            self.inc5b = _Inception(832, 384, 192, 384, 48, 128, 128)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)
            if with_pool:
                self.pool5 = nn.AdaptiveAvgPool2D(1)
            self.dropout = nn.Dropout(0.4)
            if num_classes > 0:
                self.fc = nn.Linear(1024, num_classes)
        adopt(self, device, generator)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        a1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        a2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            return self.fc(self.dropout(torch.flatten(x, 1))), a1, a2
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled in this build")
    return GoogLeNet(**kwargs)
