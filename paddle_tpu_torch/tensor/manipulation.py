"""Tensor manipulation. reference: paddle_tpu/tensor/manipulation.py
(`reshape` :41, `flatten` :64, `transpose` :78, `concat` :120, `split`
:148): the ops the vision models call."""

from __future__ import annotations

import torch

__all__ = ["reshape", "flatten", "transpose", "concat", "split"]


def _ints(values):
    if isinstance(values, torch.Tensor):
        return tuple(int(v) for v in values.tolist())
    return tuple(int(v) for v in values)


def reshape(x, shape, name=None):
    """x with `shape` (a list or a 1-D tensor of ints; -1 is inferred)."""
    return torch.reshape(x, _ints(shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis .. stop_axis merged into one."""
    return torch.flatten(x, start_axis, stop_axis)


def transpose(x, perm=None, name=None):
    """x's axes in the order `perm`; all of them reversed when None, as
    jnp.transpose does."""
    if perm is None:
        return x.permute(*reversed(range(x.dim())))
    return x.permute(*_ints(perm))


def concat(x, axis=0, name=None):
    """The tensors of the list `x` joined along `axis`."""
    return torch.cat(list(x), dim=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces of x along `axis`: `num_or_sections` equal ones
    (which must divide the axis, as jnp.split's), or one per section
    size, a -1 taking what the others leave."""
    axis = int(axis)
    size = x.shape[axis]
    if isinstance(num_or_sections, int):
        if size % num_or_sections:
            raise ValueError(f"axis {axis} of size {size} does not split "
                             f"into {num_or_sections} equal pieces")
        return list(torch.split(x, size // num_or_sections, dim=axis))
    known = sum(s for s in num_or_sections if s != -1)
    secs = [size - known if s == -1 else int(s) for s in num_or_sections]
    return list(torch.split(x, secs, dim=axis))
