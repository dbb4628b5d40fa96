from .activation import (gelu, hardsigmoid, hardswish, log_softmax, relu,
                         relu6, silu, softmax, swish, tanh)
from .attention import flash_attention, scaled_dot_product_attention, \
    sdp_kernel
from .common import dropout, embedding, linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .extras import gather_tree, max_unpool1d, max_unpool2d, max_unpool3d
from . import loss as _loss
from .loss import *  # noqa: F401,F403
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool3d)

__all__ = ["scaled_dot_product_attention", "flash_attention", "sdp_kernel",
           "embedding", "linear", "dropout", "gelu", "relu", "silu", "tanh",
           "relu6", "swish", "hardsigmoid", "hardswish", "softmax",
           "log_softmax", "batch_norm", "layer_norm", "rms_norm",
           "conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
           "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d", "lp_pool1d",
           "lp_pool2d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
           "gather_tree"]
__all__ += _loss.__all__
