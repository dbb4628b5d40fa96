"""Model FLOPs counter. reference: paddle_tpu/hapi/flops.py (:23-90;
python/paddle/hapi/dynamic_flops.py).

The reference reads XLA's cost analysis of the compiled forward. The port
runs the forward once in eval mode on zeros of `input_size`, without
autograd, under its own pricer (pir/analysis.price): a matrix product
costs 2 * out * K, a convolution 2 * out * (in / groups * prod(kernel)),
any other op its output elements.
"""

from __future__ import annotations

import torch

from ..pir.analysis import price

__all__ = ["flops"]


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total forward FLOPs of `net` at `input_size` (one shape, or a list
    of shapes for several inputs), on the device and in the dtype of the
    network's first parameter. `custom_ops` is accepted and not used: the
    reference reads it only where XLA's cost analysis is missing."""
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], int):
        input_shapes = [tuple(input_size)]
    else:
        input_shapes = [tuple(s) for s in input_size]
    p = next(iter(net.parameters()))
    xs = [torch.zeros(s, dtype=p.dtype, device=p.device)
          for s in input_shapes]
    modes = [(m, m.training) for m in net.modules()]
    net.eval()
    try:
        with torch.no_grad():
            _, cost = price(net, *xs, name="flops")
    finally:
        for m, was in modes:
            m.training = was
    if print_detail:
        print(f"Total FLOPs (pir.analysis.price): {cost.flops:.3e}")
    return int(cost.flops)
