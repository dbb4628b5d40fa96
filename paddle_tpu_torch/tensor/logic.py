"""Comparison and logical ops. reference: paddle_tpu/tensor/logic.py (all
of it). Each takes tensors or a tensor and a scalar, as jnp's."""

from __future__ import annotations

import torch

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "is_tensor", "is_empty",
    "equal_all",
]


def _cmp(name, f):
    def op(x, y, name=None):
        return f(x, y)
    op.__name__ = op.__qualname__ = name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _cmp("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _cmp("bitwise_right_shift", torch.bitwise_right_shift)


def logical_not(x, name=None):
    return torch.logical_not(x)


def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def equal_all(x, y, name=None):
    """A 0-d bool: same shape and equal everywhere."""
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)
