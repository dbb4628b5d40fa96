"""Sparse layers and functionals. reference: paddle_tpu/sparse/nn.py (the
activations, `functional.attention` :45, `_sparse_softmax` :61,
`BatchNorm`, `SyncBatchNorm`, `Conv3D`/`SubmConv3D` :147-215, `MaxPool3D`).

The 3-D convolutions densify: the input is scattered into a dense NDHWC
volume, the port's dense Conv3D runs on it, and the result is gathered at
the output sites. The sites come from the input's geometry alone: its own
sites for SubmConv3D, else those a convolution of the occupancy mask with
a ones kernel reaches (a stored zero keeps its site). The dense volume is
memory the reference spends too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..nn.layer.conv import Conv3D as _DenseConv3D
from ..nn.layer.layers import Layer
from ..nn.layer.norm import BatchNorm1D as _BatchNorm1D
from ..nn.layer.pooling import MaxPool3D as _DenseMaxPool3D

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "Softmax", "BatchNorm",
           "SyncBatchNorm", "Conv3D", "SubmConv3D", "MaxPool3D",
           "functional"]


class functional:
    """paddle.sparse.nn.functional's names."""

    @staticmethod
    def relu(x, name=None):
        from . import relu as _relu
        return _relu(x)

    @staticmethod
    def relu6(x, name=None):
        from . import relu6 as _relu6
        return _relu6(x)

    @staticmethod
    def leaky_relu(x, negative_slope=0.01, name=None):
        from . import leaky_relu as _leaky
        return _leaky(x, negative_slope)

    @staticmethod
    def softmax(x, axis=-1, name=None):
        return _sparse_softmax(x, axis)

    @staticmethod
    def attention(query, key, value, sparse_mask, key_padding_mask=None,
                  attn_mask=None, name=None):
        """Attention at `sparse_mask`'s pattern: SDDMM for the scores, the
        softmax scaled by 1/sqrt(d) over each row's stored entries, then
        the sparse @ dense product with `value`."""
        from . import SparseCooTensor, masked_matmul, matmul
        d = query.shape[-1]
        scores = masked_matmul(query, key.transpose(-1, -2),
                               sparse_mask).to_sparse_coo()
        scaled = SparseCooTensor(scores._indices,
                                 scores._values / math.sqrt(d),
                                 scores._shape, scores._coalesced)
        return matmul(_sparse_softmax(scaled, -1), value)


def _sparse_softmax(x, axis=-1):
    """Softmax over each row's stored entries, the last axis only: a
    segment max and a segment sum per linearised row (the leading
    indices)."""
    from . import SparseCooTensor, SparseCsrTensor, coalesce
    if axis not in (-1, len(x.shape) - 1):
        raise NotImplementedError("sparse softmax: last axis only")
    want_csr = isinstance(x, SparseCsrTensor)
    coo = coalesce(x.to_sparse_coo())
    nd = len(coo._shape)
    if nd < 2:
        raise NotImplementedError("sparse softmax needs >= 2 dims")
    if int(coo._indices.shape[0]) != nd:
        raise NotImplementedError(
            "sparse softmax: hybrid COO (dense trailing dims) not "
            "supported; the softmax axis must be a sparse dim")
    row_sizes = coo._shape[:-1]
    nrows = math.prod(row_sizes)
    rows = torch.zeros_like(coo._indices[0], dtype=torch.int64)
    stride = 1
    for i in range(nd - 2, -1, -1):
        rows = rows + coo._indices[i].long() * stride
        stride *= int(row_sizes[i])
    vals = coo._values
    row_max = vals.new_zeros(nrows).scatter_reduce(
        0, rows, vals, "amax", include_self=False)
    e = torch.exp(vals - row_max[rows])
    denom = e.new_zeros(nrows).index_add(0, rows, e)
    out = SparseCooTensor(coo._indices, e / denom[rows], coo._shape,
                          coalesced=True)
    return out.to_sparse_csr() if want_csr else out


class ReLU(Layer):
    def forward(self, x):
        return functional.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return functional.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return functional.leaky_relu(x, self._slope)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return functional.softmax(x, self._axis)


class BatchNorm(Layer):
    """BatchNorm over the stored values [nnz, C] (channels last): the
    port's BatchNorm1D as `_bn`, the reference's state keys."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NDHWC",
                 use_global_stats=None, name=None, *, dtype="float32",
                 device=None):
        super().__init__()
        self._bn = _BatchNorm1D(num_features, momentum=momentum,
                                epsilon=epsilon, weight_attr=weight_attr,
                                bias_attr=bias_attr, dtype=dtype,
                                device=device)

    def forward(self, x):
        from . import SparseCooTensor
        return SparseCooTensor(x._indices, self._bn(x.values()), x._shape,
                               x._coalesced)


class SyncBatchNorm(BatchNorm):
    """One process holds the whole batch, so its statistics are global:
    BatchNorm as it is, as in the reference."""


def _t3(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class Conv3D(Layer):
    """Sparse 3-D convolution: densify, the dense NDHWC convolution
    (`_conv`, the reference's key), then gather at the output sites."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC", *,
                 dtype="float32", device=None):
        super().__init__()
        self._conv = _DenseConv3D(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups,
            weight_attr=weight_attr, bias_attr=bias_attr,
            data_format="NDHWC", dtype=dtype, device=device)
        self._subm = False

    def _site_indices(self, x):
        """The active (N, D, H, W) sites of the input's indices, sorted,
        each once: [4, nsites]."""
        idx = x._indices[:4].long()
        return torch.unique(idx.T, dim=0).T

    def forward(self, x):
        from . import SparseCooTensor
        out = self._conv(x.to_dense())         # dense [N, D', H', W', C]
        sites = self._site_indices(x)
        if not self._subm:
            # the receptive field's reach of the input occupancy: a
            # convolution of the site mask with a ones kernel
            occ = torch.zeros((x.shape[0], 1) + tuple(x.shape[1:4]),
                              dtype=torch.float32, device=sites.device)
            occ[sites[0], 0, sites[1], sites[2], sites[3]] = 1.0
            ones = torch.ones((1, 1) + tuple(self._conv._kernel_size),
                              dtype=torch.float32, device=sites.device)
            reach = TF.conv3d(occ, ones, stride=_t3(self._conv._stride),
                              padding=_t3(self._conv._padding),
                              dilation=_t3(self._conv._dilation))
            sites = torch.nonzero(reach[:, 0] > 0).T
        vals = out[sites[0], sites[1], sites[2], sites[3]]   # [nsites, C]
        return SparseCooTensor(sites, vals, tuple(out.shape), coalesced=True)


class SubmConv3D(Conv3D):
    """Submanifold sparse convolution: the output sites are the input's."""

    def __init__(self, *args, **kwargs):
        kwargs.pop("key", None)
        super().__init__(*args, **kwargs)
        self._subm = True


class MaxPool3D(Layer):
    """The dense NDHWC max pool of the densified input, its nonzeros kept."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC", name=None):
        super().__init__()
        self._pool = _DenseMaxPool3D(kernel_size, stride=stride,
                                     padding=padding, data_format="NDHWC")

    def forward(self, x):
        from . import _dense_to_coo
        return _dense_to_coo(self._pool(x.to_dense()))
