from .activation import gelu, relu, silu, tanh
from .attention import flash_attention, scaled_dot_product_attention, \
    sdp_kernel
from .common import dropout, embedding, linear
from .conv import conv1d, conv2d, conv3d
from .loss import cross_entropy
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool2d, avg_pool1d,
                      avg_pool2d, avg_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool3d)

__all__ = ["scaled_dot_product_attention", "flash_attention", "sdp_kernel",
           "embedding", "linear", "dropout", "gelu", "relu", "silu", "tanh",
           "cross_entropy", "batch_norm", "layer_norm", "rms_norm",
           "conv1d", "conv2d", "conv3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "max_pool1d", "max_pool2d", "max_pool3d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool2d", "lp_pool1d",
           "lp_pool2d"]
