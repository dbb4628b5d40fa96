"""MobileNet V1, V2 and V3. reference: paddle_tpu/vision/models/mobilenet.py
(`_make_divisible` :18, `ConvBNLayer` :26, `DepthwiseSeparable` :40,
`MobileNetV1` :52, `InvertedResidual` :86, `MobileNetV2` :106,
`SqueezeExcitation` :140, `_V3Block` :155, `_MobileNetV3` :176, the V3
configurations :205-235, the constructors :238-247).

A depthwise convolution is `Conv2D(groups=channels)` (cuDNN's grouped
convolution on the card). The squeeze-excitation gate is the reference's
hardsigmoid (slope 0.1666667, not 1/6). Parameter and buffer names are the
reference's; every layer is built on `device`; `pretrained` is accepted
for the reference's signature and ignored.
"""

from __future__ import annotations

from ... import nn as pnn
from ...nn.layer.layers import Layer

__all__ = ["MobileNetV1", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_small", "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNLayer(Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act=pnn.ReLU, *, device=None):
        super().__init__()
        self.conv = pnn.Conv2D(in_c, out_c, kernel, stride=stride,
                               padding=padding, groups=groups,
                               bias_attr=False, device=device)
        self.bn = pnn.BatchNorm2D(out_c, device=device)
        self.act = act() if act is not None else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class DepthwiseSeparable(Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale, *, device=None):
        super().__init__()
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride=stride, padding=1,
                              groups=in_c, device=device)
        self.pw = ConvBNLayer(c1, c2, 1, device=device)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1,
                                 device=device)
        cfg = [  # in, c1, c2, stride
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1)]
        self.blocks = pnn.Sequential(*[
            DepthwiseSeparable(i, c1, c2, st, scale, device=device)
            for i, c1, c2, st in cfg])
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = pnn.Linear(s(1024), num_classes, device=device)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, *, device=None):
        super().__init__()
        self.use_res = stride == 1 and inp == oup
        hidden = int(round(inp * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act=pnn.ReLU6,
                                      device=device))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act=pnn.ReLU6, device=device),
            ConvBNLayer(hidden, oup, 1, act=None, device=device)]
        self.conv = pnn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        feats = [ConvBNLayer(3, in_c, 3, stride=2, padding=1, act=pnn.ReLU6,
                             device=device)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                feats.append(InvertedResidual(in_c, out_c, s if i == 0 else 1,
                                              t, device=device))
                in_c = out_c
        self.last_c = _make_divisible(1280 * max(1.0, scale))
        feats.append(ConvBNLayer(in_c, self.last_c, 1, act=pnn.ReLU6,
                                 device=device))
        self.features = pnn.Sequential(*feats)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Dropout(0.2),
                pnn.Linear(self.last_c, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class SqueezeExcitation(Layer):
    def __init__(self, ch, squeeze_ch, *, device=None):
        super().__init__()
        self.avgpool = pnn.AdaptiveAvgPool2D(1)
        self.fc1 = pnn.Conv2D(ch, squeeze_ch, 1, device=device)
        self.fc2 = pnn.Conv2D(squeeze_ch, ch, 1, device=device)
        self.relu = pnn.ReLU()
        self.hsig = pnn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


class _V3Block(Layer):
    def __init__(self, in_c, exp_c, out_c, kernel, stride, use_se, act, *,
                 device=None):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        act_layer = pnn.Hardswish if act == "hardswish" else pnn.ReLU
        layers = []
        if exp_c != in_c:
            layers.append(ConvBNLayer(in_c, exp_c, 1, act=act_layer,
                                      device=device))
        layers.append(ConvBNLayer(exp_c, exp_c, kernel, stride=stride,
                                  padding=kernel // 2, groups=exp_c,
                                  act=act_layer, device=device))
        if use_se:
            layers.append(SqueezeExcitation(
                exp_c, _make_divisible(exp_c // 4), device=device))
        layers.append(ConvBNLayer(exp_c, out_c, 1, act=None, device=device))
        self.block = pnn.Sequential(*layers)

    def forward(self, x):
        return x + self.block(x) if self.use_res else self.block(x)


class _MobileNetV3(Layer):
    def __init__(self, cfg, last_exp, last_c, scale=1.0, num_classes=1000,
                 with_pool=True, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        feats = [ConvBNLayer(3, in_c, 3, stride=2, padding=1,
                             act=pnn.Hardswish, device=device)]
        for k, exp, c, se, act, s in cfg:
            out_c = _make_divisible(c * scale)
            exp_c = _make_divisible(exp * scale)
            feats.append(_V3Block(in_c, exp_c, out_c, k, s, se, act,
                                  device=device))
            in_c = out_c
        exp_out = _make_divisible(last_exp * scale)
        feats.append(ConvBNLayer(in_c, exp_out, 1, act=pnn.Hardswish,
                                 device=device))
        self.features = pnn.Sequential(*feats)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Linear(exp_out, last_c, device=device), pnn.Hardswish(),
                pnn.Dropout(0.2),
                pnn.Linear(last_c, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None):
        cfg = [  # k, exp, c, se, act, s
            (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
            (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
            (5, 240, 40, True, "hardswish", 1),
            (5, 240, 40, True, "hardswish", 1),
            (5, 120, 48, True, "hardswish", 1),
            (5, 144, 48, True, "hardswish", 1),
            (5, 288, 96, True, "hardswish", 2),
            (5, 576, 96, True, "hardswish", 1),
            (5, 576, 96, True, "hardswish", 1)]
        super().__init__(cfg, 576, 1024, scale, num_classes, with_pool,
                         device=device)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None):
        cfg = [
            (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
            (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
            (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
            (3, 240, 80, False, "hardswish", 2),
            (3, 200, 80, False, "hardswish", 1),
            (3, 184, 80, False, "hardswish", 1),
            (3, 184, 80, False, "hardswish", 1),
            (3, 480, 112, True, "hardswish", 1),
            (3, 672, 112, True, "hardswish", 1),
            (5, 672, 160, True, "hardswish", 2),
            (5, 960, 160, True, "hardswish", 1),
            (5, 960, 160, True, "hardswish", 1)]
        super().__init__(cfg, 960, 1280, scale, num_classes, with_pool,
                         device=device)


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)
