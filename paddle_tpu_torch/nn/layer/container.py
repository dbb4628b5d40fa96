"""Containers. reference: paddle_tpu/nn/layer/layers.py (`Sequential`
:308, `LayerList`)."""

from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList"]


class LayerList(nn.ModuleList):
    """A list of layers, named "0", "1", ... (torch's ModuleList under the
    reference's parameter name)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class Sequential(nn.Sequential):
    """Layers called in order, named "0", "1", ... as given, or by the
    keys of one OrderedDict, or by the names of (name, layer) tuples."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
        else:
            super().__init__(OrderedDict(
                layer if isinstance(layer, tuple) else (str(i), layer)
                for i, layer in enumerate(layers)))
