"""reference: paddle_tpu/regularizer.py."""

from .framework.param_attr import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
