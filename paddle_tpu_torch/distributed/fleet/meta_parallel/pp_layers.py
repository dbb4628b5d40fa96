"""Pipeline model container. reference: paddle_tpu/distributed/fleet/
meta_parallel/pp_layers.py (`LayerDesc`, `SharedLayerDesc`,
`PipelineLayer`), after fleet/meta_parallel/parallel_layers/pp_layers.py
(PipelineLayer:257, LayerDesc:56, SharedLayerDesc:76, segmentation :207).

PipelineLayer builds its descriptions and cuts the layer list into
`num_stages` uniform stages; one process runs every stage in order.
"""

from __future__ import annotations

import numpy as np

from ....nn.layer.layers import Layer, LayerList

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Tied layers (e.g. embedding and unembedding): the same layer object
    wherever its key recurs."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """reference: pp_layers.py:257."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._recompute_interval = recompute_interval
        self._shared = {}
        self._descs = list(layers)
        built = []
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared:
                    layer = self._shared[d.layer_name]
                else:
                    layer = d.build_layer()
                    self._shared[d.layer_name] = layer
                built.append((layer, d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), None))
            elif isinstance(d, Layer) or callable(d):
                built.append((d, None))
            else:
                raise TypeError(f"bad pipeline entry {d!r}")
        self.run_function = built
        self._layers_list = LayerList(
            [l for l, _ in built if isinstance(l, Layer)])
        # stage segmentation (uniform by layer count, seg_method='uniform')
        n = len(built)
        per = int(np.ceil(n / self._num_stages))
        self._stage_bounds = [(i * per, min((i + 1) * per, n))
                              for i in range(self._num_stages)]

    @property
    def num_stages(self):
        return self._num_stages

    def get_stage_fns(self):
        """One callable per stage (the composition of its segment)."""
        fns = []
        for lo, hi in self._stage_bounds:
            seg = self.run_function[lo:hi]

            def stage_fn(x, _seg=seg):
                for layer, ffn in _seg:
                    x = ffn(layer, x) if ffn is not None else layer(x)
                return x

            fns.append(stage_fn)
        return fns

    def forward(self, input):
        x = input
        for layer, ffn in self.run_function:
            x = ffn(layer, x) if ffn is not None else layer(x)
        return x
