"""Quantization formats. reference: paddle_tpu/nn/quant/."""

from .format import fp8_limits

__all__ = ["fp8_limits"]
