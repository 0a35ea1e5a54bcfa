"""DenseNet (counterpart of paddle_tpu/vision/models/densenet.py): each
dense layer concatenates its features onto all the preceding ones."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(tnn.Module):
    def __init__(self, in_ch, growth_rate, bn_size, dropout):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(in_ch)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], 1)


class _DenseBlock(nn.Sequential):
    def __init__(self, num_layers, in_ch, growth_rate, bn_size, dropout):
        super().__init__(*[_DenseLayer(in_ch + i * growth_rate, growth_rate,
                                       bn_size, dropout)
                           for i in range(num_layers)])


class _Transition(nn.Sequential):
    def __init__(self, in_ch, out_ch):
        super().__init__(nn.BatchNorm2D(in_ch), nn.ReLU(),
                         nn.Conv2D(in_ch, out_ch, 1, bias_attr=False),
                         nn.AvgPool2D(2, stride=2))


class DenseNet(tnn.Module):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, device=None, generator=None):
        super().__init__()
        resolve_device(device)
        num_init, growth, block_cfg = _CFG[layers]
        self.with_pool, self.num_classes = with_pool, num_classes
        with torch.device("meta"):
            self.stem = nn.Sequential(
                nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                          bias_attr=False),
                nn.BatchNorm2D(num_init), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, padding=1))
            blocks, ch = [], num_init
            for i, n in enumerate(block_cfg):
                blocks.append(_DenseBlock(n, ch, growth, bn_size, dropout))
                ch += n * growth
                if i != len(block_cfg) - 1:
                    blocks.append(_Transition(ch, ch // 2))
                    ch //= 2
            self.features = nn.Sequential(*blocks)
            self.norm = nn.BatchNorm2D(ch)
            self.relu = nn.ReLU()
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Linear(ch, num_classes)
        adopt(self, device, generator)

    def forward(self, x):
        x = self.relu(self.norm(self.features(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _build(layers, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled in this build")
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _build(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _build(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _build(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _build(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _build(264, pretrained, **kwargs)
