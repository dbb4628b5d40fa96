"""Max unpooling and beam back-tracing. reference:
paddle_tpu/nn/functional/extras.py (`_max_unpool` :130,
`max_unpool1d/2d/3d` :153-175, `gather_tree` :355-371). The rest of that
file is not ported.

Each value of x goes to the flat spatial index `indices` gives it (as
max_pool*(return_mask=True) returns them) in an output of zeros whose
spatial size is `output_size`'s last dims, or (in - 1) * stride + kernel
per dim: the reference leaves `padding` and `data_format` out of both, and
so does the port.
"""

from __future__ import annotations

import math

import torch

from .conv import _tuple

__all__ = ["max_unpool1d", "max_unpool2d", "max_unpool3d", "gather_tree"]


def _max_unpool(x, indices, n, kernel_size, stride, output_size):
    ks = _tuple(kernel_size, n)
    sd = _tuple(stride if stride is not None else kernel_size, n)
    if output_size is not None:
        out_sp = tuple(int(s) for s in output_size[-n:])
    else:
        out_sp = tuple((si - 1) * st + k
                       for si, st, k in zip(x.shape[2:], sd, ks))
    b, c = x.shape[:2]
    out = x.new_zeros((b, c, math.prod(out_sp)))
    out = out.scatter(2, indices.reshape(b, c, -1).long(),
                      x.reshape(b, c, -1))
    return out.reshape((b, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, output_size)


def gather_tree(ids, parents):
    """Full beams from a beam search's step ids and parent beams, both
    (max_time, batch, beam): walking back from the last step, each beam
    takes its id at every step and moves to its parent there."""
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], -1)
    out = []
    for t in range(ids.shape[0] - 1, -1, -1):
        out.append(ids[t].gather(1, beam))
        beam = parents[t].gather(1, beam).long()
    return torch.stack(out[::-1])
