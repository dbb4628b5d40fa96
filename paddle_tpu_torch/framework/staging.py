"""Graph-break segments for to_static (the SOT partial-graph analog).

reference: paddle_tpu/framework/staging.py (after python/paddle/jit/sot:
the reference compiles the partial graph up to a break and goes on after
it). When capture hits data-dependent Python control flow (a
`pir.capture.GraphBreak`), `jit.to_static` runs the function in staged
mode instead of eagerly op by op:

* every torch op the function dispatches is deferred: a
  `TorchDispatchMode` computes its result on fake tensors (shape, dtype,
  device, no storage) and hands the fake back to the Python code, which
  goes on with it;
* the first concretization (`bool()`, `float()`, `.item()` of a deferred
  tensor: the graph break) flushes the pending ops as ONE captured
  program (a pir.Program whose inputs are the real tensors the ops read),
  runs it on the real tensors, and gives the Python code the real value;
* an op whose output depends on tensor data (nonzero, a boolean index)
  is a break too: the torch call that reached it flushes the pending ops
  and runs for real, above autograd, so its result keeps its gradient;
* the function's return flushes the rest, and its tensors come back real.

A function with K breaks runs as K+1 segments, each a captured program,
cached by canonical hash: a second call with the same shapes, constants
and control-flow path replays the same programs. Each segment runs under
torch autograd with the grad mode of the call, so the backward goes
through the segments as it would through the eager ops (the reference
puts each segment on its tape as one node). The user function's own
`torch.no_grad()` blocks are not seen inside staging: its ops are
recorded under no_grad and run in the call's grad mode.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["StagingScope"]

# segments kept per StaticFunction (oldest dropped first)
_MAX_SEGMENTS = 64


class _Node:
    __slots__ = ("func", "args", "kwargs", "out")

    def __init__(self, func, args, kwargs, out):
        self.func, self.args, self.kwargs, self.out = func, args, kwargs, out


class _DataDependentOp(RuntimeError):
    """An op whose output shape or value depends on tensor data reached
    the staging dispatch; _BreakMode runs the torch call above it for
    real. Escaping to the caller means no torch call could take it."""


class _StagingMode(TorchDispatchMode):
    def __init__(self, scope):
        super().__init__()
        self.scope = scope

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from ..pir.capture import DATA_DEPENDENT_ERRORS
        scope = self.scope
        kwargs = kwargs or {}
        try:
            with scope.fake_mode:
                fargs, fkwargs = pytree.tree_map_only(
                    torch.Tensor, scope.to_fake, (args, kwargs))
                out = func(*fargs, **fkwargs)
        except DATA_DEPENDENT_ERRORS as e:
            # a data-dependent op (nonzero, a boolean index): its break is
            # taken above autograd, by _BreakMode around the torch call
            # that reached it, so the op runs for real with its gradient
            raise _DataDependentOp(str(func)) from e
        leaves = out if isinstance(out, (tuple, list)) else [out]
        if leaves and all(isinstance(t, torch.Tensor) for t in leaves):
            scope.pending.append(_Node(func, args, kwargs, out))
        # anything else (prim.device, a size) is metadata: nothing to run
        return out


# the Python-level concretizations: a graph break is taken here, above
# autograd, so the flushed segment runs under torch autograd
_BREAKS = frozenset({torch.Tensor.__bool__, torch.Tensor.__float__,
                     torch.Tensor.__int__, torch.Tensor.__index__,
                     torch.Tensor.item, torch.Tensor.tolist,
                     torch.Tensor.numpy})


class _BreakMode(TorchFunctionMode):
    def __init__(self, scope):
        super().__init__()
        self.scope = scope

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        scope = self.scope
        if func in _BREAKS and any(scope._is_fake(a) for a in args):
            scope.flush()
            args = pytree.tree_map_only(torch.Tensor, scope.to_real, args)
            with _disable_current_modes():
                return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except _DataDependentOp:
            # the data-dependent op below this call is a graph break: run
            # what is pending, then this call for real in the call's grad
            # mode, so its result carries its gradient into what follows
            scope.flush()
            args, kwargs = pytree.tree_map_only(
                torch.Tensor, scope.to_real, (args, kwargs))
            with _disable_current_modes(), \
                    torch.set_grad_enabled(scope._grad):
                return func(*args, **kwargs)


class StagingScope:
    """Deferred execution of one call; `segments` counts the programs it
    ran."""

    def __init__(self, jit_cache=None):
        from torch._subclasses.fake_tensor import FakeTensorMode
        self.fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        self.pending: list[_Node] = []
        self.real = WeakIdKeyDictionary()      # fake -> real tensor
        self.jit_cache = jit_cache if jit_cache is not None else {}
        self.segments = 0
        self._grad = True

    # -- tensors ------------------------------------------------------------
    def _is_fake(self, t):
        from torch._subclasses.fake_tensor import FakeTensor
        return isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode

    def to_fake(self, t):
        if self._is_fake(t):
            return t
        f = self.fake_mode.from_tensor(t)
        self.real[f] = t
        return f

    def to_real(self, t):
        return self.real[t] if self._is_fake(t) else t

    # -- running a function -------------------------------------------------
    def run(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) in staged mode; its tensors come back real."""
        self._grad = torch.is_grad_enabled()
        with torch.no_grad(), _StagingMode(self), _BreakMode(self):
            out = fn(*args, **kwargs)
        self.flush()
        return pytree.tree_map_only(torch.Tensor, self.to_real, out)

    # -- flush: one captured segment ----------------------------------------
    def _segment(self, nodes):
        """(pir.Program of `nodes`, its real input tensors, the fakes its
        outputs stand for)."""
        from ..pir.ir import Operation, Program, Ref
        prog = Program(f"segment{self.segments}")
        vals: dict[int, object] = {}
        leaves: list = []
        outs_fake: list = []

        def value_of(t):
            f = self.to_fake(t)
            v = vals.get(id(f))
            if v is None:               # read from outside the segment
                v = prog.new_value(f.shape, f.dtype, device=f.device)
                prog.inputs.append(v)
                leaves.append(self.real[f])
                vals[id(f)] = v
            return v

        for node in nodes:
            inputs: list = []

            def ref(t):
                inputs.append(value_of(t))
                return Ref(len(inputs) - 1)

            spec = pytree.tree_map_only(torch.Tensor, ref,
                                        (tuple(node.args),
                                         dict(node.kwargs)))
            multi = isinstance(node.out, (tuple, list))
            res = list(node.out) if multi else [node.out]
            outs = [prog.new_value(r.shape, r.dtype, device=r.device)
                    for r in res]
            prog.ops.append(Operation(str(node.func), inputs, outs,
                                      eqn=(node.func, spec), multi=multi))
            for r, v in zip(res, outs):
                vals[id(r)] = v
                outs_fake.append(r)
            prog.outputs.extend(outs)
        return prog, leaves, outs_fake

    def flush(self):
        nodes, self.pending = self.pending, []
        if not nodes:
            return
        prog, leaves, outs_fake = self._segment(nodes)
        key = prog.canonical_hash()
        cached = self.jit_cache.pop(key, None)
        if cached is None:
            cached = prog
            while len(self.jit_cache) >= _MAX_SEGMENTS:
                self.jit_cache.pop(next(iter(self.jit_cache)))
        self.jit_cache[key] = cached          # most recent last
        with _disable_current_modes(), torch.set_grad_enabled(self._grad):
            outs = cached.bind(*leaves)
        for f, r in zip(outs_fake, outs):
            self.real[f] = r
        self.segments += 1
