"""MobileNet V1, V2 and V3 (counterpart of
paddle_tpu/vision/models/mobilenet.py). Depthwise convolutions are grouped
``Conv2D``s."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ._build import adopt, resolve_device

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
           "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNRelu(nn.Sequential):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 relu6=False):
        super().__init__(
            nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_ch),
            nn.ReLU6() if relu6 else nn.ReLU())


class _DepthwiseSeparable(tnn.Module):
    def __init__(self, in_ch, out_ch1, out_ch2, stride, scale):
        super().__init__()
        c1, c2 = int(out_ch1 * scale), int(out_ch2 * scale)
        self.depthwise = _ConvBNRelu(in_ch, c1, 3, stride=stride, padding=1,
                                     groups=in_ch)
        self.pointwise = _ConvBNRelu(c1, c2, 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class _Classifier(tnn.Module):
    """The pool, flatten and head every MobileNet ends with."""

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(self.flatten(x))
        return x


class MobileNetV1(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        resolve_device(device)
        self.scale, self.num_classes = scale, num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        cfg = [
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1),
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1),
        ]
        with torch.device("meta"):
            self.conv1 = _ConvBNRelu(3, s(32), 3, stride=2, padding=1)
            self.blocks = nn.Sequential(*[
                _DepthwiseSeparable(i, o1, o2, st, scale)
                for (i, o1, o2, st) in cfg])
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(s(1024), num_classes)
            self.flatten = nn.Flatten()
        adopt(self, device, generator)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


class _InvertedResidual(tnn.Module):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNRelu(inp, hidden, 1, relu6=True))
        layers += [
            _ConvBNRelu(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, relu6=True),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(_Classifier):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        resolve_device(device)
        self.num_classes, self.with_pool = num_classes, with_pool
        input_channel = _make_divisible(32 * scale)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]  # t, c, n, s
        with torch.device("meta"):
            features = [_ConvBNRelu(3, input_channel, 3, stride=2,
                                    padding=1, relu6=True)]
            for t, c, n, s in cfg:
                out_ch = _make_divisible(c * scale)
                for i in range(n):
                    features.append(_InvertedResidual(
                        input_channel, out_ch, s if i == 0 else 1, t))
                    input_channel = out_ch
            self.last_channel = _make_divisible(1280 * max(1.0, scale))
            features.append(_ConvBNRelu(input_channel, self.last_channel, 1,
                                        relu6=True))
            self.features = nn.Sequential(*features)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(0.2), nn.Linear(self.last_channel,
                                               num_classes))
            self.flatten = nn.Flatten()
        adopt(self, device, generator)


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return MobileNetV2(scale=scale, **kwargs)


class _SqueezeExcite(tnn.Module):
    """SE block with a hardsigmoid gate."""

    def __init__(self, ch, squeeze_ch):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, squeeze_ch, 1)
        self.fc2 = nn.Conv2D(squeeze_ch, ch, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        return x * self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))


class _V3Block(tnn.Module):
    """Inverted residual with an optional SE block and hardswish."""

    def __init__(self, in_ch, exp_ch, out_ch, kernel, stride, use_se,
                 use_hs):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        act = nn.Hardswish if use_hs else nn.ReLU
        layers = []
        if exp_ch != in_ch:
            layers += [nn.Conv2D(in_ch, exp_ch, 1, bias_attr=False),
                       nn.BatchNorm2D(exp_ch), act()]
        layers += [nn.Conv2D(exp_ch, exp_ch, kernel, stride=stride,
                             padding=kernel // 2, groups=exp_ch,
                             bias_attr=False),
                   nn.BatchNorm2D(exp_ch), act()]
        if use_se:
            layers.append(_SqueezeExcite(exp_ch,
                                         _make_divisible(exp_ch // 4)))
        layers += [nn.Conv2D(exp_ch, out_ch, 1, bias_attr=False),
                   nn.BatchNorm2D(out_ch)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV3(_Classifier):
    """The shared trunk: config rows are (kernel, exp, out, use_se, use_hs,
    stride)."""

    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, generator=None):
        super().__init__()
        resolve_device(device)
        self.num_classes, self.with_pool = num_classes, with_pool
        in_ch = _make_divisible(16 * scale)
        with torch.device("meta"):
            layers = [nn.Conv2D(3, in_ch, 3, stride=2, padding=1,
                                bias_attr=False),
                      nn.BatchNorm2D(in_ch), nn.Hardswish()]
            for k, exp, out, se, hs, s in config:
                exp_ch = _make_divisible(exp * scale)
                out_ch = _make_divisible(out * scale)
                layers.append(_V3Block(in_ch, exp_ch, out_ch, k, s, se, hs))
                in_ch = out_ch
            head_ch = _make_divisible(6 * in_ch)
            layers += [nn.Conv2D(in_ch, head_ch, 1, bias_attr=False),
                       nn.BatchNorm2D(head_ch), nn.Hardswish()]
            self.features = nn.Sequential(*layers)
            self.last_channel = last_channel
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(head_ch, last_channel), nn.Hardswish(),
                    nn.Dropout(0.2), nn.Linear(last_channel, num_classes))
            self.flatten = nn.Flatten()
        adopt(self, device, generator)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        cfg = [
            (3, 16, 16, True, False, 2),
            (3, 72, 24, False, False, 2),
            (3, 88, 24, False, False, 1),
            (5, 96, 40, True, True, 2),
            (5, 240, 40, True, True, 1),
            (5, 240, 40, True, True, 1),
            (5, 120, 48, True, True, 1),
            (5, 144, 48, True, True, 1),
            (5, 288, 96, True, True, 2),
            (5, 576, 96, True, True, 1),
            (5, 576, 96, True, True, 1),
        ]
        super().__init__(cfg, _make_divisible(1024 * scale), scale,
                         num_classes, with_pool, device, generator)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        cfg = [
            (3, 16, 16, False, False, 1),
            (3, 64, 24, False, False, 2),
            (3, 72, 24, False, False, 1),
            (5, 72, 40, True, False, 2),
            (5, 120, 40, True, False, 1),
            (5, 120, 40, True, False, 1),
            (3, 240, 80, False, True, 2),
            (3, 200, 80, False, True, 1),
            (3, 184, 80, False, True, 1),
            (3, 184, 80, False, True, 1),
            (3, 480, 112, True, True, 1),
            (3, 672, 112, True, True, 1),
            (5, 672, 160, True, True, 2),
            (5, 960, 160, True, True, 1),
            (5, 960, 160, True, True, 1),
        ]
        super().__init__(cfg, _make_divisible(1280 * scale), scale,
                         num_classes, with_pool, device, generator)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights in this build")
    return MobileNetV3Large(scale=scale, **kwargs)
