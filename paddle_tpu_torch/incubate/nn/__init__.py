"""Fused layers and functionals. reference: paddle_tpu/incubate/nn/."""

from . import functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                    FusedEcMoe, FusedFeedForward, FusedLinear,
                    FusedMultiHeadAttention, FusedMultiTransformer,
                    FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedLinear", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer",
           "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
           "FusedEcMoe", "FusedMultiTransformer"]
