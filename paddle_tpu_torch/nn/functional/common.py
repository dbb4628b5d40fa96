"""Common functionals in Paddle's layouts. reference:
paddle_tpu/nn/functional/common.py (`linear`, `embedding`) and
activation.py (`silu`)."""

from __future__ import annotations

import torch

__all__ = ["linear", "embedding", "silu"]


def linear(x, weight, bias=None):
    """y = x @ W + b with W shaped (in, out), Paddle's layout."""
    out = x @ weight
    return out if bias is None else out + bias


def embedding(ids, weight):
    """Rows of `weight` (num_embeddings, dim) at integer `ids`."""
    return weight[ids]


def silu(x):
    return torch.nn.functional.silu(x)
