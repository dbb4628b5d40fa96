"""VGG. reference: paddle_tpu/vision/models/vgg.py (`_CFGS`, `_make_layers`,
`VGG`, `vgg11`-`vgg19`). Every layer is built on `device`."""

from __future__ import annotations

from ... import nn as pnn
from ...nn.layer.layers import Layer

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False, device=None):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(pnn.MaxPool2D(2, stride=2))
        else:
            layers.append(pnn.Conv2D(in_c, v, 3, padding=1, device=device))
            if batch_norm:
                layers.append(pnn.BatchNorm2D(v, device=device))
            layers.append(pnn.ReLU())
            in_c = v
    return pnn.Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Linear(512 * 7 * 7, 4096, device=device), pnn.ReLU(),
                pnn.Dropout(), pnn.Linear(4096, 4096, device=device),
                pnn.ReLU(), pnn.Dropout(),
                pnn.Linear(4096, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, device=None, **kwargs):
    return VGG(_make_layers(_CFGS[cfg], batch_norm, device), device=device,
               **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
