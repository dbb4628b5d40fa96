"""Tensor manipulation. reference: paddle_tpu/tensor/manipulation.py
(`flatten` :64)."""

from __future__ import annotations

import torch

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis .. stop_axis merged into one."""
    return torch.flatten(x, start_axis, stop_axis)
