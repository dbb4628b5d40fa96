"""Tensor manipulation. reference: paddle_tpu/tensor/manipulation.py (all
of it).

The in-place forms (`reshape_`, `squeeze_`, `unsqueeze_`, `flatten_`)
rebind x to the result, as the reference's `_rebind` does. Ops whose
result size depends on the data (`masked_select`, `nonzero`, `where` with
one argument) read the mask on the host.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.dtypes import convert_dtype

__all__ = [
    "reshape", "reshape_", "flatten", "transpose", "squeeze", "squeeze_",
    "unsqueeze", "unsqueeze_", "concat", "stack", "split", "chunk", "tile",
    "expand", "expand_as", "broadcast_to", "broadcast_tensors", "flip",
    "rot90", "roll", "gather", "gather_nd", "scatter", "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "take_along_axis", "put_along_axis", "masked_select",
    "masked_fill", "where", "slice", "strided_slice", "unbind", "unstack",
    "pad", "repeat_interleave", "moveaxis", "swapaxes", "as_complex",
    "as_real", "view", "view_as", "atleast_1d", "atleast_2d", "atleast_3d",
    "tensor_split", "hsplit", "vsplit", "dsplit", "hstack", "vstack",
    "dstack", "column_stack", "row_stack", "unflatten", "unfold",
    "flatten_", "cast", "crop", "tolist", "numel", "shard_index",
    "diagonal", "diagonal_scatter", "select_scatter", "slice_scatter",
    "nonzero",
]


def _ints(values):
    if isinstance(values, torch.Tensor):
        return tuple(int(v) for v in values.reshape(-1).tolist())
    if isinstance(values, (int, np.integer)):
        return (int(values),)
    return tuple(int(v) for v in values)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _rebind(x, out):
    x.data = out.detach()
    return x


def reshape(x, shape, name=None):
    """x with `shape` (a list or a 1-D tensor of ints; -1 is inferred)."""
    return torch.reshape(x, _ints(shape))


def reshape_(x, shape, name=None):
    return _rebind(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    """reshape for a shape; for a dtype a cast, as the reference's."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.to(convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis .. stop_axis merged into one."""
    return torch.flatten(x, start_axis, stop_axis)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _rebind(x, flatten(x, start_axis, stop_axis))


def transpose(x, perm=None, name=None):
    """x's axes in the order `perm`; all of them reversed when None, as
    jnp.transpose does."""
    if perm is None:
        return x.permute(*reversed(range(x.dim())))
    return x.permute(*_ints(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(x, axis0, axis1)


def squeeze(x, axis=None, name=None):
    """x without its size-1 axes, or without those of `axis` that have
    size 1."""
    if axis is None:
        return torch.squeeze(x)
    axes = [a % x.dim() for a in _ints(axis) if x.shape[a % x.dim()] == 1]
    return torch.squeeze(x, tuple(axes)) if axes else x


def squeeze_(x, axis=None, name=None):
    return _rebind(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    """New size-1 axes at `axis` (an int, a list or a tensor), inserted in
    ascending order; a negative axis counts from x.dim() + 1."""
    axes = sorted(a % (x.dim() + 1) if a < 0 else a for a in _ints(axis))
    for a in axes:
        x = x.unsqueeze(a)
    return x


def unsqueeze_(x, axis, name=None):
    return _rebind(x, unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    """The tensors of the list `x` joined along `axis`."""
    return torch.cat(list(x), dim=_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=axis)


def hstack(x, name=None):
    return torch.hstack(list(x))


def vstack(x, name=None):
    return torch.vstack(list(x))


def dstack(x, name=None):
    return torch.dstack(list(x))


def column_stack(x, name=None):
    return torch.column_stack(list(x))


row_stack = vstack


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces of x along `axis`: `num_or_sections` equal ones
    (which must divide the axis, as jnp.split's), or one per section
    size, a -1 taking what the others leave."""
    axis = _int(axis)
    size = x.shape[axis]
    if isinstance(num_or_sections, int):
        if size % num_or_sections:
            raise ValueError(f"axis {axis} of size {size} does not split "
                             f"into {num_or_sections} equal pieces")
        return list(torch.split(x, size // num_or_sections, dim=axis))
    known = sum(s for s in num_or_sections if s != -1)
    secs = [size - known if s == -1 else int(s) for s in num_or_sections]
    return list(torch.split(x, secs, dim=axis))


def tensor_split(x, num_or_indices, axis=0, name=None):
    """np.array_split's pieces: a count (the first pieces one longer) or
    the split indices."""
    if not isinstance(num_or_indices, int):
        num_or_indices = list(_ints(num_or_indices))
    return list(torch.tensor_split(x, num_or_indices, dim=axis))


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if x.dim() > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(x, dim=axis))


unstack = unbind


def tile(x, repeat_times, name=None):
    return torch.tile(x, _ints(repeat_times))


def expand(x, shape, name=None):
    """x broadcast to `shape`; -1 keeps x's size of that axis."""
    target = list(_ints(shape))
    off = len(target) - x.dim()
    for i, t in enumerate(target):
        if t == -1:
            target[i] = x.shape[i - off]
    return x.expand(*target)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return x.expand(*_ints(shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis, name=None):
    return torch.flip(x, _ints(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def _take(x, index, axis):
    """jnp.take(x, index, axis): index's shape in place of x's axis."""
    axis = axis % x.dim()
    if index.dim() == 0:
        return x.select(axis, int(index))
    out = x.index_select(axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


def gather(x, index, axis=0, name=None):
    """Slices of x along `axis` at `index` (flattened when it has more than
    one axis)."""
    axis = _int(axis)
    return _take(x, index.reshape(-1) if index.dim() > 1 else index, axis)


def gather_nd(x, index, name=None):
    """x at the leading coordinates of index's last axis."""
    return x[tuple(index[..., i] for i in range(index.shape[-1]))]


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of x at `index` set to `updates`, or, without `overwrite`,
    zeroed and then summed with every update of that row."""
    index = index.reshape(-1)
    out = x.clone()
    if overwrite:
        out[index] = updates.to(x.dtype)
        return out
    out[index] = 0
    return out.index_put((index,), updates.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    ix = tuple(index[..., i] for i in range(index.shape[-1]))
    return x.index_put(ix, updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(_ints(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis=0, name=None):
    return _take(x, index, axis)


def index_sample(x, index, name=None):
    """x[i, index[i, j]] for each row i."""
    return torch.gather(x, 1, index)


def index_add(x, index, axis, value, name=None):
    return torch.index_add(x, axis, index, value.to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    return x.index_put(tuple(indices), value.to(x.dtype),
                       accumulate=accumulate)


def _along(arr, indices, axis):
    """arr and indices broadcast against each other on every axis but
    `axis`, as jnp.take_along_axis broadcasts them."""
    axis = axis % arr.dim()
    a, i = list(arr.shape), list(indices.shape)
    a[axis] = i[axis] = 1
    b = list(torch.broadcast_shapes(tuple(a), tuple(i)))
    ab, ib = list(b), list(b)
    ab[axis], ib[axis] = arr.shape[axis], indices.shape[axis]
    return arr.expand(*ab), indices.expand(*ib), axis


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr, indices, axis = _along(arr, indices, axis)
    return torch.gather(arr, axis, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    """arr with `values` (broadcast to indices' shape) written, added
    ("add") or multiplied ("mul", "multiply") at `indices` along `axis`."""
    if not isinstance(values, torch.Tensor):
        values = torch.tensor(values, dtype=arr.dtype, device=arr.device)
    values = values.to(arr.dtype).expand(*indices.shape)
    axis = axis % arr.dim()
    if reduce == "assign":
        return arr.scatter(axis, indices, values)
    if reduce == "add":
        return arr.scatter_add(axis, indices, values)
    if reduce in ("mul", "multiply"):
        return arr.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(reduce)


def masked_select(x, mask, name=None):
    """The elements of x where `mask` (broadcast to x) holds, as 1-D."""
    return x[mask.expand_as(x)]


def masked_fill(x, mask, value, name=None):
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(mask, value.to(x.dtype), x)


def where(condition, x=None, y=None, name=None):
    """x where `condition` holds, else y; with neither, the coordinates of
    condition's nonzero elements as a tuple."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return torch.where(condition, x, y)


def nonzero(x, as_tuple=False):
    """(n, x.dim()) int64 coordinates of x's nonzero elements, or a tuple
    of one 1-D tensor per axis."""
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def _slices(x, axes, starts, ends, strides=None):
    sl = [builtins.slice(None)] * x.dim()
    strides = strides or [1] * len(axes)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        sl[ax] = builtins.slice(_int(s), _int(e), _int(st))
    return sl


def slice(input, axes, starts, ends, name=None):
    """input[starts:ends] on each of `axes` (Python's clamping)."""
    return input[tuple(_slices(input, axes, starts, ends))]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """x[start:end:stride] on each of `axes`, negative strides included."""
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        n = out.shape[ax]
        idx = range(*builtins.slice(_int(s), _int(e), _int(st)).indices(n))
        out = out.index_select(ax, torch.tensor(list(idx), dtype=torch.long,
                                                device=x.device))
    return out


def crop(x, shape=None, offsets=None, name=None):
    offs = list(offsets or [0] * x.dim())
    shp = list(shape)
    for i, s in enumerate(shp):
        if s == -1:
            shp[i] = x.shape[i] - offs[i]
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]


def _pad_widths(p, nd, data_format, pad_from_left_axis):
    """The reference's reading of a Paddle pad list: (before, after) per
    axis."""
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        return width if pad_from_left_axis else width[::-1]
    if len(p) == 4 and nd == 4:
        if data_format == "NCHW":
            return [(0, 0), (0, 0), (p[2], p[3]), (p[0], p[1])]
        return [(0, 0), (p[2], p[3]), (p[0], p[1]), (0, 0)]
    if len(p) == 2 and nd == 3:
        if data_format == "NCL":
            return [(0, 0), (0, 0), (p[0], p[1])]
        return [(0, 0), (p[0], p[1]), (0, 0)]
    if len(p) == 6 and nd == 5:
        if data_format == "NCDHW":
            return [(0, 0), (0, 0), (p[4], p[5]), (p[2], p[3]), (p[0], p[1])]
        return [(0, 0), (p[4], p[5]), (p[2], p[3]), (p[0], p[1]), (0, 0)]
    return [(0, 0)] * (nd - len(p) // 2) + [(p[2 * i], p[2 * i + 1])
                                            for i in range(len(p) // 2)]


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    """x padded by `pad`, read as the reference reads it: one (before,
    after) pair per axis from the first when it covers them all, else the
    spatial axes of `data_format`. "reflect", "replicate" and "circular"
    gather the source index np.pad gives each padded position."""
    width = _pad_widths(list(_ints(pad)), x.dim(), data_format,
                        pad_from_left_axis)
    if mode == "constant":
        flat = [w for pair in reversed(width) for w in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    np_mode = {"reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}[mode]
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            src = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = x.index_select(ax, torch.as_tensor(src, device=x.device))
    return x


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


def _atleast(f, inputs):
    outs = [f(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, inputs)


def unflatten(x, axis, shape, name=None):
    return torch.unflatten(x, axis, tuple(shape))


def unfold(x, axis, size, step, name=None):
    """Windows of `size` every `step` along `axis`: that axis becomes the
    window count and the window is a new last axis."""
    return x.unfold(axis, size, step)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    out = x.clone()
    out[tuple(_slices(x, axes, starts, ends, strides))] = value.to(x.dtype)
    return out


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Ids of shard `shard_id` (of `nshards` equal shards of `index_num`)
    made local to it; the others `ignore_value`."""
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    inside = (input >= lo) & (input < lo + shard_size)
    return torch.where(inside, input - lo, ignore_value)


def tolist(x):
    return x.tolist()


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)
