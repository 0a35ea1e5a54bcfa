"""ShuffleNet V2 (counterpart of paddle_tpu/vision/models/shufflenetv2.py):
channel-split and channel-shuffle units."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...nn.functional import channel_shuffle
from ._build import adopt, resolve_device

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512],
    0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}


class _ConvBNAct(nn.Sequential):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 act="relu"):
        layers = [nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                            padding=padding, groups=groups, bias_attr=False),
                  nn.BatchNorm2D(out_ch)]
        if act == "relu":
            layers.append(nn.ReLU())
        elif act == "swish":
            layers.append(nn.Swish())
        super().__init__(*layers)


class _ShuffleUnit(tnn.Module):
    """stride 1: split the channels, transform one half, shuffle."""

    def __init__(self, ch, act):
        super().__init__()
        half = ch // 2
        self.half = half
        self.branch = nn.Sequential(
            _ConvBNAct(half, half, 1, act=act),
            _ConvBNAct(half, half, 3, padding=1, groups=half, act="none"),
            _ConvBNAct(half, half, 1, act=act))

    def forward(self, x):
        out = torch.cat([x[:, :self.half], self.branch(x[:, self.half:])], 1)
        return channel_shuffle(out, 2)


class _ShuffleDownUnit(tnn.Module):
    """stride 2: both branches downsample; the concat doubles the
    channels."""

    def __init__(self, in_ch, out_ch, act):
        super().__init__()
        half = out_ch // 2
        self.branch1 = nn.Sequential(
            _ConvBNAct(in_ch, in_ch, 3, stride=2, padding=1, groups=in_ch,
                       act="none"),
            _ConvBNAct(in_ch, half, 1, act=act))
        self.branch2 = nn.Sequential(
            _ConvBNAct(in_ch, half, 1, act=act),
            _ConvBNAct(half, half, 3, stride=2, padding=1, groups=half,
                       act="none"),
            _ConvBNAct(half, half, 1, act=act))

    def forward(self, x):
        return channel_shuffle(
            torch.cat([self.branch1(x), self.branch2(x)], 1), 2)


class ShuffleNetV2(tnn.Module):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None, generator=None):
        super().__init__()
        resolve_device(device)
        self.num_classes, self.with_pool = num_classes, with_pool
        chs = _STAGE_OUT[scale]
        with torch.device("meta"):
            self.stem = nn.Sequential(
                _ConvBNAct(3, chs[0], 3, stride=2, padding=1, act=act),
                nn.MaxPool2D(3, stride=2, padding=1))
            stages, in_ch = [], chs[0]
            for stage_i, repeats in enumerate([4, 8, 4]):
                out_ch = chs[stage_i + 1]
                stages.append(_ShuffleDownUnit(in_ch, out_ch, act))
                for _ in range(repeats - 1):
                    stages.append(_ShuffleUnit(out_ch, act))
                in_ch = out_ch
            self.stages = nn.Sequential(*stages)
            self.head_conv = _ConvBNAct(in_ch, chs[4], 1, act=act)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(chs[4], num_classes)
        adopt(self, device, generator)

    def forward(self, x):
        x = self.head_conv(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _build(scale, act="relu", pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled in this build")
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _build(0.25, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _build(0.33, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _build(0.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _build(1.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _build(1.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _build(2.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _build(1.0, act="swish", pretrained=pretrained, **kwargs)
