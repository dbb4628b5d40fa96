"""Matrix products. reference: paddle_tpu/tensor/math.py (`matmul` :343,
`mm`, `bmm` :361) and paddle_tpu/tensor/einsum.py; each an AMP white op
(amp._cast) under the reference's name."""

from __future__ import annotations

import torch

from ..amp import _cast

__all__ = ["matmul", "mm", "bmm", "einsum"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _cast("matmul", x, y)
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


mm = matmul


def bmm(x, y, name=None):
    return torch.matmul(*_cast("bmm", x, y))


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return torch.einsum(equation, *_cast("einsum", *operands))
