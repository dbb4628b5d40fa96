"""Normalization layers. reference: paddle_tpu/nn/layer/norm.py
(`_BatchNormBase` :18-40, `BatchNorm`/`BatchNorm1D/2D/3D` :43-57,
`LayerNorm` :80, `RMSNorm` :99, `GroupNorm` :112, `InstanceNorm1D/2D/3D`
:130-157, `LocalResponseNorm` :160, `SpectralNorm` :168). `SyncBatchNorm`
waits for the distributed modules."""

from __future__ import annotations

import torch

from ...framework.device import resolve_device
from .. import functional as F
from ..initializer import Constant, Normal
from .common import _param
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class _BatchNormBase(Layer):
    """Batch norm over `num_features` channels: weight ones and bias zeros
    unless `weight_attr` / `bias_attr` name an initializer (left out when
    False), and the running statistics as the float32 buffers `_mean`
    (zeros) and `_variance` (ones), the reference's names, so state-dict
    keys match its. Training updates them in place (F.batch_norm);
    `momentum` is Paddle's, the share of the old value kept."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, dtype="float32",
                 device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = ("NCHW" if data_format in
                             ("NC", "NCL", "NCHW", "NCDHW") else "NHWC")
        self._use_global_stats = use_global_stats
        self.weight = _param(weight_attr, Constant(1.0), (num_features,),
                             dtype, device)
        self.bias = _param(bias_attr, Constant(0.0), (num_features,), dtype,
                           device)
        device = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class LayerNorm(Layer):
    """LayerNorm over the trailing `normalized_shape` axes; weight ones and
    bias zeros unless `weight_attr` / `bias_attr` name an initializer, and
    left out when False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, dtype="float32", device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = _param(weight_attr, Constant(1.0),
                             self.normalized_shape, dtype, device)
        self.bias = _param(bias_attr, Constant(0.0), self.normalized_shape,
                           dtype, device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class RMSNorm(Layer):
    """Llama-family RMSNorm with a ones-initialized weight unless
    `weight_attr` names an initializer."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, dtype="float32", device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(weight_attr, Constant(1.0), (hidden_size,),
                             dtype, device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    """F.group_norm over `num_groups` groups of `num_channels`; weight ones
    and bias zeros (left out when False)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, dtype="float32", device=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = _param(weight_attr, Constant(1.0), (num_channels,),
                             dtype, device)
        self.bias = _param(bias_attr, Constant(0.0), (num_channels,), dtype,
                           device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """F.instance_norm in NCHW-style layout (the reference's forward passes
    no data_format), weight ones and bias zeros (left out when False)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, dtype="float32", device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = _param(weight_attr, Constant(1.0), (num_features,),
                             dtype, device)
        self.bias = _param(bias_attr, Constant(0.0), (num_features,), dtype,
                           device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """weight / sigma, sigma its largest singular value as `power_iters`
    steps of power iteration from the frozen parameters `weight_u` (h,)
    and `weight_v` (w,) estimate it, with weight seen as (h, w): its axis
    `dim` first, the rest flattened. The iteration carries no gradient
    and does not update u and v, as in the reference."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = _param(None, Normal(0.0, 1.0), (h,), dtype, device)
        self.weight_v = _param(None, Normal(0.0, 1.0), (w,), dtype, device)
        self.weight_u.requires_grad_(False)
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        wm = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                  -1)
        u, v = self.weight_u, self.weight_v
        with torch.no_grad():
            for _ in range(self._power_iters):
                v = wm.T @ u
                v = v / (torch.linalg.norm(v) + self._epsilon)
                u = wm @ v
                u = u / (torch.linalg.norm(u) + self._epsilon)
        return weight / (u @ wm @ v)
