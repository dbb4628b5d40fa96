"""Capture: trace a torch function on fake tensors into a pir.Program.

reference: paddle_tpu/pir/capture.py, which lowers one `jax.make_jaxpr`
trace. Here the trace is `torch.fx.experimental.proxy_tensor.make_fx` in
fake mode: the function runs once on FakeTensors (shapes, dtypes and
devices, no storage), every aten or registered custom op it dispatches
becomes one fx node, and each node becomes one Operation that keeps its
OpOverload and arguments for replay. Factory calls (`torch.ones(...)`) are
ops too; tensors the function closes over become constants.

Capture never runs on real tensors. A data-dependent Python branch (a
`bool()`, `float()` or `.item()` of a traced tensor) cannot be resolved on
a fake tensor and raises `GraphBreak`, the counterpart of jax's
ConcretizationTypeError: `jit.to_static` turns it into staged segments
(framework/staging.py), `full_graph=True` re-raises it.

Effect scopes (reference :26-44): the paged-KV writes run inside
`effect_scope("kv.write")` / `effect_scope("kv.rollback")`
(ops/paged_attention.py). Outside a capture a scope is a no-op; during one
it tags the fx node of every in-place op dispatched inside it, and the
lowered op is
stamped `attrs["effect"]` and `attrs["effect_seq"]` (captured program
order) for the verifier's effect-order rule. The port writes the cache in
place, so the mark is carried by the node, not by a name stack.
"""

from __future__ import annotations

import contextlib
import operator
import threading
from typing import Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .ir import Operation, Program, Ref

__all__ = ["capture", "from_graph_module", "GraphBreak", "effect_scope",
           "DATA_DEPENDENT_ERRORS"]


class GraphBreak(RuntimeError):
    """The captured function reached data-dependent Python control flow:
    a tensor value was needed on the host while tracing fake tensors."""


def _data_dependent_errors():
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    errs = [DataDependentOutputException, DynamicOutputShapeException]
    try:
        from torch.fx.experimental.symbolic_shapes import \
            GuardOnDataDependentSymNode
        errs.append(GuardOnDataDependentSymNode)
    except ImportError:  # pragma: no cover - older torch
        pass
    return tuple(errs)


DATA_DEPENDENT_ERRORS = _data_dependent_errors()

_state = threading.local()


class _EffectTagger(TorchDispatchMode):
    """Active inside an effect scope during a capture: after each in-place
    op (its schema mutates an argument) dispatched inside, tags the fx node
    the proxy tracer just appended. The scope's pure ops (index
    arithmetic, casts, views) stay ordinary."""

    def __init__(self, scope, graph):
        super().__init__()
        self.scope = scope
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = len(self.graph.nodes)
        out = func(*args, **(kwargs or {}))
        if func._schema.is_mutable and len(self.graph.nodes) > before:
            node = next(iter(reversed(self.graph.nodes)))
            node.meta["pir_effect"] = self.scope
        return out


@contextlib.contextmanager
def effect_scope(name: str):
    """Mark the ops run inside as a stateful effect of kind `name` (one of
    verifier.EFFECT_SCOPES) in any program captured around them; a no-op
    outside a capture."""
    graph = getattr(_state, "graph", None)
    if graph is None:
        yield
        return
    with _EffectTagger(name, graph):
        yield


def _proxy_graph():
    """The graph make_fx's proxy mode is appending to, or None."""
    try:
        mode = torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.PROXY)
        return mode.tracer.graph if mode is not None else None
    except Exception:  # noqa: BLE001 — scope tagging is best-effort
        return None


def _val_of(node):
    return node.meta.get("val")


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def from_graph_module(gm, name: str = "program") -> Program:
    """Lower an aten-level fx GraphModule (make_fx's) to a Program."""
    prog = Program(name)
    env: dict = {}            # fx.Node -> Value or [Value]
    eff_seq = 0

    def new_value(t):
        return prog.new_value(t.shape, t.dtype, device=t.device)

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            v = new_value(_val_of(node))
            prog.inputs.append(v)
            env[node] = v
        elif node.op == "get_attr":
            t = getattr(gm, node.target)
            env[node] = prog.add_constant(t.detach())
        elif node.op == "call_function" and node.target is operator.getitem:
            src, idx = node.args
            env[node] = env[src][idx]
        elif node.op == "call_function":
            target = node.target
            if not isinstance(target, torch._ops.OpOverload):
                raise NotImplementedError(
                    f"capture: unsupported fx call {target!r}")
            inputs: list = []

            def ref(a):
                if isinstance(a, torch.fx.Node):
                    val = env[a]
                    if isinstance(val, list):
                        raise NotImplementedError(
                            f"capture: list-valued operand of {target}")
                    inputs.append(val)
                    return Ref(len(inputs) - 1)
                return a

            spec = pytree.tree_map(ref, (tuple(node.args),
                                         dict(node.kwargs)),
                                   is_leaf=lambda a: isinstance(
                                       a, torch.fx.Node))
            val = _val_of(node)
            multi = isinstance(val, (tuple, list))
            vals = list(val) if multi else [val]
            outs = [new_value(t) for t in vals if _is_tensor(t)]
            if len(outs) != len(vals):
                raise NotImplementedError(
                    f"capture: {target} returned a non-tensor result")
            op = Operation(str(target), inputs, outs, eqn=(target, spec),
                           multi=multi)
            scope = node.meta.get("pir_effect")
            if scope is not None:
                # stamp captured program order for the effect-order rule;
                # attrs on captured ops stay out of the canonical hash
                op.attrs["effect"] = scope
                op.attrs["effect_seq"] = eff_seq
                eff_seq += 1
            prog.ops.append(op)
            env[node] = outs if multi else outs[0]
        elif node.op == "output":
            leaves = pytree.tree_leaves(node.args[0])
            prog.outputs = [env[a] for a in leaves]
    return prog


def _is_data_dependent(e) -> bool:
    if isinstance(e, DATA_DEPENDENT_ERRORS):
        return True
    msg = str(e)
    return ("data-dependent" in msg or "data dependent" in msg
            or "Cannot access data pointer" in msg)


def capture(fn: Callable, *example_args, name: str = None):
    """Trace `fn(*example_args)` (tensors in; a tensor or a pytree of
    tensors out) on fake tensors and lower it. Returns (Program, out_spec),
    out_spec the outputs' pytree spec (program outputs are its leaves).
    Raises GraphBreak on data-dependent control flow."""
    from torch.fx.experimental.proxy_tensor import make_fx
    box = {}

    def flat(*args):
        graph = _proxy_graph()
        prev = getattr(_state, "graph", None)
        _state.graph = graph
        try:
            out = fn(*args)
        finally:
            _state.graph = prev
        leaves, box["spec"] = pytree.tree_flatten(out)
        return tuple(leaves)

    try:
        gm = make_fx(flat, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*example_args)
        # autograd's saved-tensor detaches (and any other unused pure
        # node) go before lowering; in-place and random nodes are impure
        # and stay. A data-dependent output shape (nonzero, a boolean
        # index) traces as an unbacked size and breaks in the lowering.
        gm.graph.eliminate_dead_code()
        prog = from_graph_module(gm, name or getattr(fn, "__name__",
                                                     "program"))
    except GraphBreak:
        raise
    except Exception as e:  # noqa: BLE001 — classify, re-raise
        if _is_data_dependent(e):
            raise GraphBreak(f"data-dependent control flow in "
                             f"{getattr(fn, '__name__', fn)!r}: {e}") from e
        raise
    try:
        from ..observability.catalog import metric
        metric("pir_captures_total").inc()
    except Exception:  # noqa: BLE001 — capture never fails over metrics
        pass
    return prog, box["spec"]
