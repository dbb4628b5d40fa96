"""The serving engine's static cost model.

reference: paddle_tpu/pir/analysis.py — `OpCost` and `ProgramCost`
(:436-465), the per-equation pricing rule `_eqn_cost` (:394-422) and
`DEFAULT_ROOFLINE` (:329).

The reference prices a program from its jaxpr before XLA compiles it. The
port has no program IR yet (ROADMAP.md, slice 6), so `price` runs the
program once under a `TorchDispatchMode` and prices every aten op that
reaches the dispatcher, by the reference's rule:

  - `mm`, `bmm`, `addmm`, `baddbmm` and `matmul` cost 2 * out * K flops;
  - `convolution` costs 2 * out * (in / groups * prod(kernel)) flops, or
    2 * input * (out / groups * prod(kernel)) transposed, as XLA's cost
    analysis counts it (the reference's jaxpr rule takes 10 * out, an
    elementwise floor for an op the Llama stack never emits;
    hapi.flops counts convolutions by this one);
  - any other op costs its output elements;
  - bytes are the op's tensor inputs plus its outputs;
  - raw_seconds = max(flops / (peak * efficiency), bytes / hbm_bps).

One departure: an op that returns a view (`OpOverload.is_view`: view,
select, transpose, permute, expand, ...) is free. It moves no byte and does
no arithmetic, and the port's Python loop over layers selects each layer's
slice of the KV pool, where the reference's scan slices it implicitly:
priced by the rule, that select alone would charge the whole pool's bytes
to every layer.

`DEFAULT_ROOFLINE` holds the H100's own bounds: 989e12 FLOP/s of dense
bf16 and 3.35e12 B/s of HBM, with efficiency 1.0, because the engine's
calibration (its first measured dispatch sets the scale) absorbs the rest.
The mode only reads shapes and dtypes, so pricing a CUDA program adds no
synchronisation.
"""

from __future__ import annotations

import math

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost", "ProgramCost", "DEFAULT_ROOFLINE", "price"]

DEFAULT_ROOFLINE = {
    "peak_flops": 989e12,
    "efficiency": 1.0,
    "hbm_bps": 3.35e12,
}

# the matrix products, and the argument whose last dim is the contraction K
_PRODUCT_K_ARG = {"mm": 0, "bmm": 0, "matmul": 0, "addmm": 1, "baddbmm": 1}


class OpCost:
    __slots__ = ("flops", "bytes")

    def __init__(self, flops=0.0, bytes=0.0):
        self.flops = float(flops)
        self.bytes = float(bytes)

    def __repr__(self):
        return f"OpCost(flops={self.flops:.3g}, bytes={self.bytes:.3g})"


class ProgramCost:
    """Aggregate static price of one program. ``raw_seconds`` is the
    uncalibrated roofline estimate; callers apply a measured calibration
    scale on top. ``per_op`` is [(aten op name, OpCost summed over its
    calls)], heaviest first. The communication terms stay 0.0 until the
    mesh is ported."""

    __slots__ = ("name", "flops", "bytes", "raw_seconds", "per_op",
                 "comm_seconds", "exposed_comm_seconds")

    def __init__(self, name, flops, bytes, raw_seconds, per_op,
                 comm_seconds=0.0, exposed_comm_seconds=0.0):
        self.name = name
        self.flops = flops
        self.bytes = bytes
        self.raw_seconds = raw_seconds
        self.per_op = per_op
        self.comm_seconds = float(comm_seconds)
        self.exposed_comm_seconds = float(exposed_comm_seconds)

    def __repr__(self):
        return (f"ProgramCost({self.name!r}, {self.flops:.3g} flops, "
                f"{self.bytes:.3g} B, {self.raw_seconds:.3g}s raw)")


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class _Pricer(TorchDispatchMode):
    """Sums the reference's per-op price over every aten op it sees."""

    def __init__(self):
        super().__init__()
        self.per_op: dict[str, OpCost] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        outs = _tensors(out)
        nbytes = sum(t.numel() * t.element_size()
                     for t in _tensors((args, kwargs)) + outs)
        name = func.overloadpacket.__name__
        k_arg = _PRODUCT_K_ARG.get(name)
        if k_arg is not None and outs:
            flops = 2.0 * outs[0].numel() * args[k_arg].shape[-1]
        elif name == "convolution":
            x, w, transposed = args[0], args[1], args[6]
            flops = 2.0 * (x if transposed else outs[0]).numel() * \
                math.prod(w.shape[1:])
        else:
            flops = float(sum(t.numel() for t in outs))
        c = self.per_op.setdefault(name, OpCost())
        c.flops += flops
        c.bytes += nbytes
        return out


def price(fn, *args, name="program"):
    """Run `fn(*args)` once and price every aten op it dispatches at
    DEFAULT_ROOFLINE. Returns (its result, ProgramCost)."""
    roof = DEFAULT_ROOFLINE
    pricer = _Pricer()
    with pricer:
        out = fn(*args)
    flops = sum(c.flops for c in pricer.per_op.values())
    nbytes = sum(c.bytes for c in pricer.per_op.values())
    eff_flops = roof["peak_flops"] * roof["efficiency"]
    raw = max(flops / eff_flops if eff_flops > 0 else 0.0,
              nbytes / roof["hbm_bps"] if roof["hbm_bps"] > 0 else 0.0)
    per_op = sorted(pricer.per_op.items(),
                    key=lambda nc: -(nc[1].flops + nc[1].bytes))
    return out, ProgramCost(name, flops, nbytes, raw, per_op)
