from .attention import scaled_dot_product_attention, sdp_kernel
from .common import embedding, linear, silu
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["scaled_dot_product_attention", "sdp_kernel", "embedding",
           "linear", "silu", "cross_entropy", "rms_norm"]
