"""Common layers. reference: paddle_tpu/nn/layer/common.py (all of it) and
`create_parameter`'s defaults (nn/layer/layers.py:48-77).

Each layer takes the reference's parameters in the reference's order,
`name` included (accepted and ignored, as there), and then the port's own
`dtype` and `device` as keyword-only parameters.

Parameter names and shapes follow the reference so that `state_dict()` keys
and shapes equal the JAX model's: `Linear.weight` is (in, out).
`weight_attr` and `bias_attr` take a `ParamAttr` (its initializer,
`trainable`, `name` and `learning_rate`, as the reference's
`create_parameter` reads them), an initializer (nn/initializer.py), or
None for the reference's default; `bias_attr=False` leaves the bias out.
"""

from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Normal
from .layers import Layer, _param

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
           "CosineSimilarity", "Bilinear", "Identity", "Unfold", "Fold",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle"]


class Identity(Layer):
    """Its input, as it is; any arguments are accepted and ignored."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(Layer):
    """y = x @ W + b with W (in_features, out_features); XavierUniform
    weight and zero bias (or the global initializers) unless `weight_attr`
    / `bias_attr` name an initializer."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype="float32", device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param(weight_attr, None, (in_features, out_features),
                             dtype, device)
        self.bias = _param(bias_attr, None, (out_features,), dtype, device,
                           is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """Lookup table (num_embeddings, embedding_dim), Normal(0, 1) unless
    `weight_attr` names an initializer. The row at `padding_idx` (negative:
    counted from the end) starts at zero and its lookups give zeros.
    `sparse` is accepted and ignored, as the reference does."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 dtype="float32", device=None):
        super().__init__()
        self.padding_idx = (padding_idx if padding_idx is None
                            or padding_idx >= 0
                            else num_embeddings + padding_idx)
        self.weight = _param(weight_attr, Normal(0.0, 1.0),
                             (num_embeddings, embedding_dim), dtype, device)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, ids: torch.Tensor):
        return F.embedding(ids, self.weight, self.padding_idx)


class Dropout(Layer):
    """F.dropout with the module's training flag."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    """F.interpolate with the arguments it was built with."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with aligned corners, as the reference's."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadN):
    pass


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadN):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """out = x1 . W[o] . x2 + b with W (out, in1, in2) and b (1, out)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 dtype="float32", device=None):
        super().__init__()
        self.weight = _param(weight_attr, None,
                             (out_features, in1_features, in2_features),
                             dtype, device)
        self.bias = _param(bias_attr, None, (1, out_features), dtype, device,
                           is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.r, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.r, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
