"""AlexNet, SqueezeNet and ShuffleNetV2. reference:
paddle_tpu/vision/models/small_nets.py (`AlexNet` :17, `_Fire` :51,
`SqueezeNet` :65, `_channel_shuffle` :116, `_ShuffleUnit` :123,
`ShuffleNetV2` :163, the constructors).

ShuffleNetV2's channel shuffle is the reference's reshape, transpose and
reshape of (n, groups, c / groups, h, w). Parameter and buffer names are
the reference's; every layer is built on `device`; `pretrained` is
accepted and ignored.
"""

from __future__ import annotations

from ... import nn as pnn
from ...tensor import concat, reshape, transpose
from ...nn.layer.layers import Layer

__all__ = ["AlexNet", "alexnet", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1", "ShuffleNetV2", "shufflenet_v2_x0_25",
           "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


class AlexNet(Layer):
    def __init__(self, num_classes=1000, dropout=0.5, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        d = dict(device=device)
        self.features = pnn.Sequential(
            pnn.Conv2D(3, 64, 11, stride=4, padding=2, **d), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2),
            pnn.Conv2D(64, 192, 5, padding=2, **d), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2),
            pnn.Conv2D(192, 384, 3, padding=1, **d), pnn.ReLU(),
            pnn.Conv2D(384, 256, 3, padding=1, **d), pnn.ReLU(),
            pnn.Conv2D(256, 256, 3, padding=1, **d), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2))
        self.avgpool = pnn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Dropout(dropout), pnn.Linear(256 * 6 * 6, 4096, **d),
                pnn.ReLU(), pnn.Dropout(dropout),
                pnn.Linear(4096, 4096, **d), pnn.ReLU(),
                pnn.Linear(4096, num_classes, **d))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


class _Fire(Layer):
    def __init__(self, in_c, squeeze, e1, e3, *, device=None):
        super().__init__()
        self.squeeze = pnn.Conv2D(in_c, squeeze, 1, device=device)
        self.expand1 = pnn.Conv2D(squeeze, e1, 1, device=device)
        self.expand3 = pnn.Conv2D(squeeze, e3, 3, padding=1, device=device)
        self.relu = pnn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(x)),
                       self.relu(self.expand3(x))], axis=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        d = dict(device=device)
        if version == "1.0":
            self.features = pnn.Sequential(
                pnn.Conv2D(3, 96, 7, stride=2, **d), pnn.ReLU(),
                pnn.MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64, **d), _Fire(128, 16, 64, 64, **d),
                _Fire(128, 32, 128, 128, **d), pnn.MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128, **d), _Fire(256, 48, 192, 192, **d),
                _Fire(384, 48, 192, 192, **d), _Fire(384, 64, 256, 256, **d),
                pnn.MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256, **d))
        else:
            self.features = pnn.Sequential(
                pnn.Conv2D(3, 64, 3, stride=2, **d), pnn.ReLU(),
                pnn.MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64, **d), _Fire(128, 16, 64, 64, **d),
                pnn.MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128, **d), _Fire(256, 32, 128, 128, **d),
                pnn.MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192, **d), _Fire(384, 48, 192, 192, **d),
                _Fire(384, 64, 256, 256, **d), _Fire(512, 64, 256, 256, **d))
        if num_classes > 0:
            self.final_conv = pnn.Conv2D(512, num_classes, 1, **d)
        self.relu = pnn.ReLU()
        self.dropout = pnn.Dropout(0.5)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.relu(self.final_conv(self.dropout(x)))
        if self.with_pool:
            x = self.pool(x)
            if self.num_classes > 0:
                x = x.flatten(1)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet(version="1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet(version="1.1", **kwargs)


def _channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = reshape(x, [n, groups, c // groups, h, w])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [n, c, h, w])


class _ShuffleUnit(Layer):
    def __init__(self, in_c, out_c, stride, act, *, device=None):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        act_layer = pnn.Swish if act == "swish" else pnn.ReLU
        d = dict(bias_attr=False, device=device)
        if stride > 1:
            self.branch1 = pnn.Sequential(
                pnn.Conv2D(in_c, in_c, 3, stride=stride, padding=1,
                           groups=in_c, **d),
                pnn.BatchNorm2D(in_c, device=device),
                pnn.Conv2D(in_c, branch_c, 1, **d),
                pnn.BatchNorm2D(branch_c, device=device), act_layer())
            b2_in = in_c
        else:
            self.branch1 = None
            b2_in = in_c // 2
        self.branch2 = pnn.Sequential(
            pnn.Conv2D(b2_in, branch_c, 1, **d),
            pnn.BatchNorm2D(branch_c, device=device), act_layer(),
            pnn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                       groups=branch_c, **d),
            pnn.BatchNorm2D(branch_c, device=device),
            pnn.Conv2D(branch_c, branch_c, 1, **d),
            pnn.BatchNorm2D(branch_c, device=device), act_layer())

    def forward(self, x):
        if self.stride > 1:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        else:
            c = x.shape[1] // 2
            out = concat([x[:, :c], self.branch2(x[:, c:])], axis=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    _STAGE_OUT = {
        0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
        0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
        1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048]}

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = self._STAGE_OUT[scale]
        act_layer = pnn.Swish if act == "swish" else pnn.ReLU
        self.conv1 = pnn.Sequential(
            pnn.Conv2D(3, cfg[0], 3, stride=2, padding=1, bias_attr=False,
                       device=device),
            pnn.BatchNorm2D(cfg[0], device=device), act_layer())
        self.max_pool = pnn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_c = cfg[0]
        for stage_i, rep in enumerate([4, 8, 4]):
            out_c = cfg[stage_i + 1]
            units = [_ShuffleUnit(in_c, out_c, 2, act, device=device)]
            units += [_ShuffleUnit(out_c, out_c, 1, act, device=device)
                      for _ in range(rep - 1)]
            stages.append(pnn.Sequential(*units))
            in_c = out_c
        self.stages = pnn.Sequential(*stages)
        self.conv_last = pnn.Sequential(
            pnn.Conv2D(in_c, cfg[-1], 1, bias_attr=False, device=device),
            pnn.BatchNorm2D(cfg[-1], device=device), act_layer())
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = pnn.Linear(cfg[-1], num_classes, device=device)

    def forward(self, x):
        x = self.conv_last(self.stages(self.max_pool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)
