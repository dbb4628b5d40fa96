from .activation import gelu, relu, silu, tanh
from .attention import flash_attention, scaled_dot_product_attention, \
    sdp_kernel
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["scaled_dot_product_attention", "flash_attention", "sdp_kernel",
           "embedding", "linear", "dropout", "gelu", "relu", "silu", "tanh",
           "cross_entropy", "layer_norm", "rms_norm"]
