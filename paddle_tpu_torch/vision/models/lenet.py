"""LeNet-5. reference: paddle_tpu/vision/models/lenet.py. Every layer is
built on `device`."""

from __future__ import annotations

from ... import nn as pnn
from ...tensor import flatten
from ...nn.layer.layers import Layer

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            pnn.Conv2D(1, 6, 3, stride=1, padding=1, device=device),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            pnn.Conv2D(6, 16, 5, stride=1, padding=0, device=device),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = pnn.Sequential(
                pnn.Linear(400, 120, device=device),
                pnn.Linear(120, 84, device=device),
                pnn.Linear(84, num_classes, device=device))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
