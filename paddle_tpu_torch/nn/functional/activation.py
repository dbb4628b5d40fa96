"""Activation functionals. reference: paddle_tpu/nn/functional/activation.py
(`relu` :30, `tanh` :33, `silu` :34, `gelu` :68)."""

from __future__ import annotations

import torch

__all__ = ["relu", "tanh", "silu", "gelu"]


def relu(x, name=None):
    return torch.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return torch.nn.functional.silu(x)


def gelu(x, approximate=False, name=None):
    """x * Phi(x) by erf, or with approximate=True the tanh form
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), as jax.nn.gelu."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
