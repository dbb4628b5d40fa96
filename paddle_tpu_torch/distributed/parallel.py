"""DataParallel. reference: paddle_tpu/distributed/parallel.py (after
python/paddle/parallel.py DataParallel and the C++ EagerReducer).

One process holds the global batch and the global parameters, so the
gradients are already the all-reduced ones: the wrapper keeps the API
(no_sync, scale_loss, the state dict of the wrapped layers) and runs the
layers as they are. As the reference's, it reduces nothing across
processes.
"""

from __future__ import annotations

import contextlib

from ..nn.layer.layers import Layer

__all__ = ["DataParallel"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        yield

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.set_state_dict(state_dict, *a, **k)
