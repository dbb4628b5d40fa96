"""DenseNet. reference: paddle_tpu/vision/models/densenet.py (`_ARCH` :12,
`_DenseLayer` :21, `_DenseBlock` :42, `_Transition` :55, `DenseNet` :68,
the constructors :103-119).

Every dense layer concatenates its input with its growth-rate new
channels (torch.cat), so each block's tensors grow layer by layer as the
reference's do. Parameter and buffer names are the reference's; every
layer is built on `device`; `pretrained` is accepted and ignored.
"""

from __future__ import annotations

from ... import nn as pnn
from ...tensor import concat
from ...nn.layer.layers import Layer

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_ARCH = {
    121: (32, [6, 12, 24, 16], 64),
    161: (48, [6, 12, 36, 24], 96),
    169: (32, [6, 12, 32, 32], 64),
    201: (32, [6, 12, 48, 32], 64),
    264: (32, [6, 12, 64, 48], 64),
}


class _DenseLayer(Layer):
    def __init__(self, in_c, growth_rate, bn_size, dropout, *, device=None):
        super().__init__()
        self.bn1 = pnn.BatchNorm2D(in_c, device=device)
        self.conv1 = pnn.Conv2D(in_c, bn_size * growth_rate, 1,
                                bias_attr=False, device=device)
        self.bn2 = pnn.BatchNorm2D(bn_size * growth_rate, device=device)
        self.conv2 = pnn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                                padding=1, bias_attr=False, device=device)
        self.relu = pnn.ReLU()
        self.dropout = pnn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class _DenseBlock(Layer):
    def __init__(self, num_layers, in_c, growth_rate, bn_size, dropout, *,
                 device=None):
        super().__init__()
        self.layers = pnn.LayerList([
            _DenseLayer(in_c + i * growth_rate, growth_rate, bn_size,
                        dropout, device=device)
            for i in range(num_layers)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Transition(Layer):
    def __init__(self, in_c, out_c, *, device=None):
        super().__init__()
        self.bn = pnn.BatchNorm2D(in_c, device=device)
        self.conv = pnn.Conv2D(in_c, out_c, 1, bias_attr=False,
                               device=device)
        self.relu = pnn.ReLU()
        self.pool = pnn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, *, device=None):
        super().__init__()
        growth_rate, block_cfg, num_init = _ARCH[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = pnn.Sequential(
            pnn.Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False,
                       device=device),
            pnn.BatchNorm2D(num_init, device=device), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2, padding=1))
        blocks = []
        ch = num_init
        for i, n in enumerate(block_cfg):
            blocks.append(_DenseBlock(n, ch, growth_rate, bn_size, dropout,
                                      device=device))
            ch += n * growth_rate
            if i != len(block_cfg) - 1:
                blocks.append(_Transition(ch, ch // 2, device=device))
                ch //= 2
        self.blocks = pnn.Sequential(*blocks)
        self.bn_final = pnn.BatchNorm2D(ch, device=device)
        self.relu = pnn.ReLU()
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = pnn.Linear(ch, num_classes, device=device)

    def forward(self, x):
        x = self.relu(self.bn_final(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def densenet121(pretrained=False, **kwargs):
    return DenseNet(layers=121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return DenseNet(layers=161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return DenseNet(layers=169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return DenseNet(layers=201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return DenseNet(layers=264, **kwargs)
