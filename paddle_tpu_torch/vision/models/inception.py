"""GoogLeNet and InceptionV3. reference:
paddle_tpu/vision/models/inception.py (`_BasicConv` :13, `_Inception` :25,
`GoogLeNet` :42, `_InceptionA` - `_InceptionE` :100-181, `InceptionV3`
:184, the constructors).

GoogLeNet returns (main, aux1, aux2) whenever it has a classifier, in
training and in eval mode, as the reference does; its aux heads pool a
14 x 14 map to 4 x 4 (uneven bins, the reference's rule). Parameter and
buffer names are the reference's; every layer is built on `device`;
`pretrained` is accepted and ignored.
"""

from __future__ import annotations

from ... import nn as pnn
from ...tensor import concat
from ...nn.layer.layers import Layer

__all__ = ["GoogLeNet", "googlenet", "InceptionV3", "inception_v3"]


class _BasicConv(Layer):
    def __init__(self, in_c, out_c, kernel, *, device=None, **kw):
        super().__init__()
        self.conv = pnn.Conv2D(in_c, out_c, kernel, bias_attr=False,
                               device=device, **kw)
        self.bn = pnn.BatchNorm2D(out_c, device=device)
        self.relu = pnn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _Inception(Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, pool_proj, *,
                 device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = _BasicConv(in_c, c1, 1, **d)
        self.b2 = pnn.Sequential(_BasicConv(in_c, c3r, 1, **d),
                                 _BasicConv(c3r, c3, 3, padding=1, **d))
        self.b3 = pnn.Sequential(_BasicConv(in_c, c5r, 1, **d),
                                 _BasicConv(c5r, c5, 5, padding=2, **d))
        self.b4 = pnn.Sequential(pnn.MaxPool2D(3, stride=1, padding=1),
                                 _BasicConv(in_c, pool_proj, 1, **d))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                      axis=1)


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        d = dict(device=device)
        self.stem = pnn.Sequential(
            _BasicConv(3, 64, 7, stride=2, padding=3, **d),
            pnn.MaxPool2D(3, stride=2, padding=1),
            _BasicConv(64, 64, 1, **d),
            _BasicConv(64, 192, 3, padding=1, **d),
            pnn.MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32, **d)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64, **d)
        self.pool3 = pnn.MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64, **d)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64, **d)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64, **d)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64, **d)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128, **d)
        self.pool4 = pnn.MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128, **d)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128, **d)
        if with_pool:
            self.pool5 = pnn.AdaptiveAvgPool2D(1)
        self.dropout = pnn.Dropout(0.4)
        if num_classes > 0:
            self.fc = pnn.Linear(1024, num_classes, **d)
            self.aux1 = pnn.Sequential(pnn.AdaptiveAvgPool2D(4))
            self.aux1_fc = pnn.Sequential(
                pnn.Linear(512 * 16, 1024, **d), pnn.ReLU(),
                pnn.Dropout(0.7), pnn.Linear(1024, num_classes, **d))
            self.aux2 = pnn.Sequential(pnn.AdaptiveAvgPool2D(4))
            self.aux2_fc = pnn.Sequential(
                pnn.Linear(528 * 16, 1024, **d), pnn.ReLU(),
                pnn.Dropout(0.7), pnn.Linear(1024, num_classes, **d))

    def forward(self, x):
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        a1 = (self.aux1_fc(self.aux1(x).flatten(1))
              if self.num_classes > 0 else None)
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = (self.aux2_fc(self.aux2(x).flatten(1))
              if self.num_classes > 0 else None)
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x).flatten(1))
            return x, a1, a2
        return x


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)


class _InceptionA(Layer):
    def __init__(self, in_c, pool_features, *, device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = _BasicConv(in_c, 64, 1, **d)
        self.b5 = pnn.Sequential(_BasicConv(in_c, 48, 1, **d),
                                 _BasicConv(48, 64, 5, padding=2, **d))
        self.b3 = pnn.Sequential(_BasicConv(in_c, 64, 1, **d),
                                 _BasicConv(64, 96, 3, padding=1, **d),
                                 _BasicConv(96, 96, 3, padding=1, **d))
        self.bp = pnn.Sequential(pnn.AvgPool2D(3, stride=1, padding=1),
                                 _BasicConv(in_c, pool_features, 1, **d))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                      axis=1)


class _InceptionB(Layer):
    def __init__(self, in_c, *, device=None):
        super().__init__()
        d = dict(device=device)
        self.b3 = _BasicConv(in_c, 384, 3, stride=2, **d)
        self.b3d = pnn.Sequential(_BasicConv(in_c, 64, 1, **d),
                                  _BasicConv(64, 96, 3, padding=1, **d),
                                  _BasicConv(96, 96, 3, stride=2, **d))
        self.pool = pnn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _InceptionC(Layer):
    def __init__(self, in_c, c7, *, device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = _BasicConv(in_c, 192, 1, **d)
        self.b7 = pnn.Sequential(
            _BasicConv(in_c, c7, 1, **d),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3), **d),
            _BasicConv(c7, 192, (7, 1), padding=(3, 0), **d))
        self.b7d = pnn.Sequential(
            _BasicConv(in_c, c7, 1, **d),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0), **d),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3), **d),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0), **d),
            _BasicConv(c7, 192, (1, 7), padding=(0, 3), **d))
        self.bp = pnn.Sequential(pnn.AvgPool2D(3, stride=1, padding=1),
                                 _BasicConv(in_c, 192, 1, **d))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                      axis=1)


class _InceptionD(Layer):
    def __init__(self, in_c, *, device=None):
        super().__init__()
        d = dict(device=device)
        self.b3 = pnn.Sequential(_BasicConv(in_c, 192, 1, **d),
                                 _BasicConv(192, 320, 3, stride=2, **d))
        self.b7 = pnn.Sequential(
            _BasicConv(in_c, 192, 1, **d),
            _BasicConv(192, 192, (1, 7), padding=(0, 3), **d),
            _BasicConv(192, 192, (7, 1), padding=(3, 0), **d),
            _BasicConv(192, 192, 3, stride=2, **d))
        self.pool = pnn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _InceptionE(Layer):
    def __init__(self, in_c, *, device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = _BasicConv(in_c, 320, 1, **d)
        self.b3_1 = _BasicConv(in_c, 384, 1, **d)
        self.b3_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1), **d)
        self.b3_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0), **d)
        self.b3d_1 = pnn.Sequential(_BasicConv(in_c, 448, 1, **d),
                                    _BasicConv(448, 384, 3, padding=1, **d))
        self.b3d_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1), **d)
        self.b3d_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0), **d)
        self.bp = pnn.Sequential(pnn.AvgPool2D(3, stride=1, padding=1),
                                 _BasicConv(in_c, 192, 1, **d))

    def forward(self, x):
        b3 = self.b3_1(x)
        b3 = concat([self.b3_2a(b3), self.b3_2b(b3)], axis=1)
        b3d = self.b3d_1(x)
        b3d = concat([self.b3d_2a(b3d), self.b3d_2b(b3d)], axis=1)
        return concat([self.b1(x), b3, b3d, self.bp(x)], axis=1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        d = dict(device=device)
        self.stem = pnn.Sequential(
            _BasicConv(3, 32, 3, stride=2, **d), _BasicConv(32, 32, 3, **d),
            _BasicConv(32, 64, 3, padding=1, **d), pnn.MaxPool2D(3, stride=2),
            _BasicConv(64, 80, 1, **d), _BasicConv(80, 192, 3, **d),
            pnn.MaxPool2D(3, stride=2))
        self.blocks = pnn.Sequential(
            _InceptionA(192, 32, **d), _InceptionA(256, 64, **d),
            _InceptionA(288, 64, **d), _InceptionB(288, **d),
            _InceptionC(768, 128, **d), _InceptionC(768, 160, **d),
            _InceptionC(768, 160, **d), _InceptionC(768, 192, **d),
            _InceptionD(768, **d), _InceptionE(1280, **d),
            _InceptionE(2048, **d))
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = pnn.Dropout(0.5)
            self.fc = pnn.Linear(2048, num_classes, **d)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x).flatten(1))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)
