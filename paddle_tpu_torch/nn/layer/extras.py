"""The less common layers. reference: paddle_tpu/nn/layer/extras.py (all
of it). `HSigmoidLoss` and `AdaptiveLogSoftmaxWithLoss` draw their weights
as the reference does (normal, scaled by the fan-in's inverse square
root), from the port's generator."""

from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.random import get_generator
from .. import functional as F
from .layers import Layer

__all__ = [
    "ZeroPad1D", "ZeroPad3D", "Unflatten", "Softmax2D", "PairwiseDistance",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D", "FractionalMaxPool2D",
    "FractionalMaxPool3D", "MultiMarginLoss", "HSigmoidLoss",
    "FeatureAlphaDropout", "ParameterDict", "RNNTLoss",
    "AdaptiveLogSoftmaxWithLoss",
]


def _normal(shape, scale, device):
    dev = resolve_device(device)
    return nn.Parameter(torch.randn(shape, device=dev,
                                    generator=get_generator(dev)) * scale)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.pad(x, self.padding, "constant", 0.0, self.data_format)


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.pad(x, self.padding, "constant", 0.0, self.data_format)


class Unflatten(Layer):
    """Axis `axis` expanded into `shape`."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, list(shape)

    def forward(self, x):
        return torch.unflatten(x, self.axis, self.shape)


class Softmax2D(Layer):
    """Softmax over the channels of (N)CHW."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError("Softmax2D expects CHW or NCHW")
        return F.softmax(x, axis=-3)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class _MaxUnPoolN(Layer):
    _ndim = 2

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        fn = getattr(F, f"max_unpool{self._ndim}d")
        return fn(x, indices, self.kernel_size, self.stride, self.padding,
                  output_size=self.output_size)


class MaxUnPool1D(_MaxUnPoolN):
    _ndim = 1


class MaxUnPool2D(_MaxUnPoolN):
    _ndim = 2


class MaxUnPool3D(_MaxUnPoolN):
    _ndim = 3


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size, self.random_u = output_size, random_u
        self.return_mask = return_mask

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       random_u=self.random_u,
                                       return_mask=self.return_mask)


class FractionalMaxPool3D(FractionalMaxPool2D):
    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       random_u=self.random_u,
                                       return_mask=self.return_mask)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin, self.weight = p, margin, weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class HSigmoidLoss(Layer):
    """F.hsigmoid_loss with its own tree weights: weight (num_classes,
    feature_size) drawn N(0, 1 / feature_size), bias zeros (left out when
    bias_attr is False)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError(
                "HSigmoidLoss: custom trees are not supported (default "
                "complete binary tree only)")
        self.num_classes = num_classes
        self.weight = _normal((num_classes, feature_size),
                              feature_size ** -0.5, device)
        self.bias = None
        if bias_attr is not False:
            self.bias = nn.Parameter(torch.zeros(
                num_classes, device=resolve_device(device)))

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, training=self.training)


class ParameterDict(Layer):
    """Parameters by name, registered on the layer in insertion order."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.update(parameters)

    def __getitem__(self, key):
        return self._parameters[key]

    def __setitem__(self, key, parameter):
        self.add_parameter(key, parameter)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def __contains__(self, key):
        return key in self._parameters

    def keys(self):
        return self._parameters.keys()

    def values(self):
        return self._parameters.values()

    def items(self):
        return self._parameters.items()

    def update(self, parameters):
        items = parameters.items() if hasattr(parameters, "items") \
            else parameters
        for k, v in items:
            self.add_parameter(k, v)
        return self


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank, self.fastemit_lambda = blank, fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax head (Grave et al. 2017): `head_weight` (in,
    cutoffs[0] + clusters), optional zero `head_bias`, and per cluster i a
    down-projection `tail_proj_i` (in, in // div_value^(i+1)) and class
    weights `tail_cls_i`; forward gives F.adaptive_log_softmax_with_loss's
    (log-probabilities of the labels, loss)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if not cutoffs or cutoffs != sorted(set(cutoffs)) \
                or cutoffs[-1] > n_classes - 1:
            raise ValueError(f"invalid cutoffs {cutoffs} for "
                             f"n_classes={n_classes}")
        self.in_features, self.n_classes = in_features, n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        n_clusters = len(cutoffs)
        head_size = cutoffs[0] + n_clusters
        s = in_features ** -0.5
        self.head_weight = _normal((in_features, head_size), s, device)
        self.head_bias = (nn.Parameter(torch.zeros(
            head_size, device=resolve_device(device))) if head_bias
            else None)
        self.tail_weights = []
        for i in range(n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            proj = _normal((in_features, hsz), s, device)
            cls_w = _normal((hsz, osz), hsz ** -0.5, device)
            self.add_parameter(f"tail_proj_{i}", proj)
            self.add_parameter(f"tail_cls_{i}", cls_w)
            self.tail_weights.append((f"tail_proj_{i}", f"tail_cls_{i}"))

    def _tails(self):
        return [(getattr(self, a), getattr(self, b))
                for a, b in self.tail_weights]

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self._tails(), self.cutoffs[:-1],
            head_bias=self.head_bias)

    def log_prob(self, input):
        """(N, n_classes) log-probabilities."""
        head = input @ self.head_weight
        if self.head_bias is not None:
            head = head + self.head_bias
        head_lp = torch.log_softmax(head, -1)
        c0 = self.cutoffs[0]
        pieces = [head_lp[:, :c0]]
        for i, (proj, cls_w) in enumerate(self._tails()):
            pieces.append(head_lp[:, c0 + i:c0 + i + 1]
                          + torch.log_softmax((input @ proj) @ cls_w, -1))
        return torch.cat(pieces, -1)
