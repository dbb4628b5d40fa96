"""PIR-lite program IR: Value / Operation / Program.

reference: paddle_tpu/pir/ir.py (after paddle/pir/include/core/, the
Operation/Value SSA IR between program capture and the backend).

The captured program is a torch graph (pir/capture.py lowers the aten graph
`make_fx` records on fake tensors), so the IR is a thin, mutable SSA view
over it: each Operation either wraps one captured node (an aten or custom
`OpOverload` with its arguments, replayed as that torch call) or is a
`pt.*` op carrying a Python callable installed by a rewrite pattern or the
fusion pass. Replaying every op as the torch call it was keeps the
evaluator faithful (an op no pass touched runs exactly what was captured,
under torch autograd), while the program is an object that can be printed,
hashed, transformed and used as a compile-cache key.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

__all__ = ["Value", "Operation", "Program", "Ref", "canonical_attr_text",
           "dtype_name", "tensor_digest"]

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def _scrub(text: str) -> str:
    """Make repr-derived text process-stable (drop heap addresses)."""
    return _ADDR_RE.sub("0x", text)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def tensor_digest(t: torch.Tensor) -> str:
    """sha256 prefix of a tensor's bytes (host copy, row-major)."""
    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


class Ref:
    """Placeholder for operand i of an op inside its argument template."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __repr__(self):
        return f"Ref({self.i})"


def canonical_attr_text(v) -> str:
    """Deterministic, process-stable rendering of an op argument or
    attribute: tensors render as a content digest, callables by name,
    torch dtypes/devices/layouts by their names; no id() and no address."""
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return repr(v)
    if isinstance(v, float):
        return repr(v)          # keeps -0.0 and inf apart
    if isinstance(v, Ref):
        return f"%in{v.i}"
    if isinstance(v, torch.dtype):
        return f"dtype({dtype_name(v)})"
    if isinstance(v, (torch.device, torch.layout, torch.memory_format)):
        return f"{type(v).__name__}({v})"
    if isinstance(v, dict):
        items = ", ".join(f"{canonical_attr_text(k)}: {canonical_attr_text(x)}"
                          for k, x in sorted(v.items(),
                                             key=lambda kv: repr(kv[0])))
        return "{" + items + "}"
    if isinstance(v, (tuple, list)):
        body = ", ".join(canonical_attr_text(x) for x in v)
        return ("(" + body + ")") if isinstance(v, tuple) else \
            ("[" + body + "]")
    if isinstance(v, torch.Tensor):
        return (f"tensor({dtype_name(v.dtype)}, {tuple(v.shape)}, "
                f"{tensor_digest(v)})")
    if callable(v):
        return f"fn<{getattr(v, '__name__', type(v).__name__)}>"
    return _scrub(repr(v))


class Value:
    """One SSA value: produced by exactly one Operation (or a program input
    or constant), consumed by any number. `sharding` is an optional
    annotation (a mesh-axes spec) read by the sharding-consistency analysis;
    None until a propagation pass or a caller stamps it, and never part of
    the canonical hash."""

    __slots__ = ("vid", "shape", "dtype", "device", "op", "sharding")

    def __init__(self, vid: int, shape, dtype,
                 op: Optional["Operation"] = None, *, device=None):
        self.vid = vid
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else None
        self.op = op          # defining op; None for inputs / constants
        self.sharding = None

    @property
    def type_str(self) -> str:
        return f"{dtype_name(self.dtype)}[{','.join(map(str, self.shape))}]"

    @property
    def sharding_str(self) -> str:
        """Printable sharding suffix (`<dp,*>`; empty when unannotated);
        display only, never part of canonical_text."""
        if self.sharding is None:
            return ""
        return ("<" + ",".join("*" if a is None else str(a)
                               for a in self.sharding) + ">")

    def __repr__(self):
        return f"%{self.vid}: {self.type_str}{self.sharding_str}"


def _constrained(v, x):
    """Replay hook for an annotated value (reference ir.py:70-76): the
    sharding hint of `v.sharding` on `x` under the active mesh scope (no
    scope, or any failure: x unchanged). On one card it marks the tensors a
    program returns (shard_prop.apply_constraint)."""
    from .shard_prop import apply_constraint
    return apply_constraint(x, v.sharding)


def _fill(spec, vals):
    return pytree.tree_map(lambda a: vals[a.i] if isinstance(a, Ref) else a,
                           spec, is_leaf=lambda a: isinstance(a, Ref))


def _filler(spec):
    """A fast `vals -> (args, kwargs)` for an argument template whose Refs
    sit at the top level or one list deep (every aten schema's shape); any
    other template falls back to the pytree walk."""
    args, kwargs = spec
    top, nested, kw = [], [], []
    for p, a in enumerate(args):
        if isinstance(a, Ref):
            top.append((p, a.i))
        elif isinstance(a, (list, tuple)) and any(
                isinstance(x, Ref) for x in a):
            if any(isinstance(x, (list, tuple, dict)) for x in a):
                return lambda vals: _fill(spec, vals)
            nested.append((p, type(a), [(j, x.i) for j, x in enumerate(a)
                                        if isinstance(x, Ref)]))
    for k, a in kwargs.items():
        if isinstance(a, Ref):
            kw.append((k, a.i))
        elif isinstance(a, (list, tuple, dict)):
            return lambda vals: _fill(spec, vals)

    def fill(vals):
        out = list(args)
        for p, i in top:
            out[p] = vals[i]
        for p, kind, items in nested:
            lst = list(args[p])
            for j, i in items:
                lst[j] = vals[i]
            out[p] = kind(lst)
        if not kw:
            return out, kwargs
        kws = dict(kwargs)
        for k, i in kw:
            kws[k] = vals[i]
        return out, kws

    return fill


class Operation:
    """One op. A captured op has `eqn`, the captured call (target, spec):
    `target` a torch OpOverload and `spec` its (args, kwargs) with each
    tensor operand replaced by Ref(i) into `inputs` (the counterpart of the
    reference's JaxprEqn); it replays as `target(*args, **kwargs)`. A
    `pt.*` op has `fn`,
    a callable over its inputs installed by a pattern or the fusion pass.
    `in_types` and `n_out` are the operand types and result count the op
    was captured with (the verifier's arity and operand-type reference);
    `multi` says the op returns a tuple or list (one Value per element)
    rather than a tensor."""

    __slots__ = ("name", "inputs", "outputs", "attrs", "target", "spec",
                 "fn", "in_types", "n_out", "multi", "_canon", "_fill",
                 "_types")

    def __init__(self, name: str, inputs: list, outputs: list,
                 attrs: Optional[dict] = None, eqn=None,
                 fn: Optional[Callable] = None, *, multi: bool = False):
        self.name = name
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.attrs = dict(attrs or {})
        self.target, self.spec = eqn if eqn is not None else (None, None)
        self.fn = fn
        self.multi = multi
        self.in_types = ([(v.shape, dtype_name(v.dtype)) for v in inputs]
                         if self.target is not None else None)
        self.n_out = len(self.outputs)
        self._canon = None
        self._fill = None
        self._types = None      # the verifier's last type derivation
        for o in self.outputs:
            o.op = self

    def has_effects(self) -> bool:
        """Mutating (in-place, out=) or random ops: pinned live by DCE and
        never folded, merged or fused."""
        t = self.target
        if t is None:
            return False
        return bool(t._schema.is_mutable
                    or torch.Tag.nondeterministic_seeded in t.tags)

    def named_args(self) -> dict:
        """The op's non-operand arguments by schema name (pt ops: attrs)."""
        if self.target is None:
            return dict(self.attrs)
        args, kwargs = self.spec
        out = {}
        for a, v in zip(self.target._schema.arguments, args):
            out[a.name] = v
        out.update(kwargs)
        return {k: v for k, v in out.items()
                if not isinstance(v, Ref) and not (
                    isinstance(v, (list, tuple))
                    and any(isinstance(x, Ref) for x in v))}

    def attr_text(self) -> str:
        if self._canon is None:
            params = (self.spec if self.target is not None else
                      {k: v for k, v in self.attrs.items()})
            self._canon = canonical_attr_text(params)
        return self._canon

    def evaluate(self, in_vals: list) -> list:
        """Run this op on tensors (real or fake)."""
        if self.fn is not None:
            out = self.fn(*in_vals)
            return list(out) if isinstance(out, (tuple, list)) else [out]
        if self._fill is None:
            self._fill = _filler(self.spec)
        args, kwargs = self._fill(in_vals)
        out = self.target(*args, **kwargs)
        return list(out) if self.multi else [out]

    def __repr__(self):
        outs = ", ".join(repr(o) for o in self.outputs)
        ins = ", ".join(f"%{v.vid}" for v in self.inputs)
        return f"{outs} = {self.name}({ins})"


class Program:
    """A captured program: inputs -> ops (topological) -> outputs, plus
    bound constants (tensors the captured function closed over, and the
    results the fold pass computed)."""

    def __init__(self, name: str = "program"):
        self.name = name
        self.inputs: list[Value] = []
        self.ops: list[Operation] = []
        self.outputs: list[Value] = []
        self.constants: dict[Value, Any] = {}   # Value -> tensor
        self._next_vid = 0
        # the mesh the sharding pass pinned: the replay hints the
        # annotated results under it (a region's sub-program has none)
        self._mesh = None

    # -- construction -------------------------------------------------------
    def new_value(self, shape, dtype, op=None, *, device=None) -> Value:
        v = Value(self._next_vid, shape, dtype, op, device=device)
        self._next_vid += 1
        return v

    def add_constant(self, t: torch.Tensor) -> Value:
        v = self.new_value(t.shape, t.dtype, device=t.device)
        self.constants[v] = t
        return v

    # -- queries ------------------------------------------------------------
    def users(self) -> dict:
        """Value -> [Operation] consumer map; program outputs count as a
        None user."""
        u: dict[Value, list] = {}
        for op in self.ops:
            for v in op.inputs:
                u.setdefault(v, []).append(op)
        for v in self.outputs:
            u.setdefault(v, []).append(None)
        return u

    def num_ops(self) -> int:
        return len(self.ops)

    # -- mutation (rewrites) ------------------------------------------------
    def replace_region(self, region_ops: list, new_op: Operation):
        """Replace a connected set of ops with one op, spliced where the
        region's last op sat. The new op produces the region's own output
        Values (users need no rewiring) and reads only values defined
        outside the region."""
        region = set(map(id, region_ops))
        idx = max(i for i, op in enumerate(self.ops) if id(op) in region)
        out = []
        for i, op in enumerate(self.ops):
            if id(op) not in region:
                out.append(op)
            elif i == idx:
                out.append(new_op)
        self.ops = out

    # -- execution ----------------------------------------------------------
    def bind(self, *args):
        """Evaluate the program on tensors: captured ops replay as their
        torch calls, pt ops through their callables. Differentiable by
        torch autograd wherever each op is. A program with a pinned mesh
        passes its annotated results through the replay hook."""
        if len(args) != len(self.inputs):
            raise TypeError(f"{self.name}: expected {len(self.inputs)} "
                            f"args, got {len(args)}")
        env: dict[int, Any] = {}
        for v, a in zip(self.inputs, args):
            env[id(v)] = a
        for v, c in self.constants.items():
            env[id(v)] = c
        for op in self.ops:
            outs = op.evaluate([env[id(v)] for v in op.inputs])
            for v, o in zip(op.outputs, outs):
                env[id(v)] = o
        if self._mesh is None:
            return tuple(env[id(v)] for v in self.outputs)
        return tuple(env[id(v)] if v.sharding is None
                     else _constrained(v, env[id(v)])
                     for v in self.outputs)

    # -- printing / hashing -------------------------------------------------
    def to_string(self, include_attrs: bool = True, max_ops: int = 0) -> str:
        """One op per line, SSA-numbered (reference: pir Program::Print)."""
        lines = [f"program @{self.name} ("
                 + ", ".join(repr(v) for v in self.inputs) + ") {"]
        for v in self.constants:
            lines.append(f"  %{v.vid} = const : {v.type_str}")
        shown = self.ops if not max_ops else self.ops[:max_ops]
        for op in shown:
            outs = ", ".join(repr(o) for o in op.outputs)
            ins = ", ".join(f"%{v.vid}" for v in op.inputs)
            attr = ""
            if include_attrs:
                shown_attrs = {k: v for k, v in op.named_args().items()
                               if not callable(v) or isinstance(
                                   v, (torch.dtype, torch.device))}
                if shown_attrs:
                    attr = " {" + ", ".join(
                        f"{k}={canonical_attr_text(v)}"
                        for k, v in sorted(shown_attrs.items())) + "}"
            lines.append(f"  {outs} = \"{op.name}\"({ins}){attr}")
        if max_ops and len(self.ops) > max_ops:
            lines.append(f"  ... ({len(self.ops) - max_ops} more ops)")
        lines.append("  return " + ", ".join(f"%{v.vid}"
                                             for v in self.outputs))
        lines.append("}")
        return "\n".join(lines)

    __str__ = to_string

    def __repr__(self):
        return (f"<pir.Program @{self.name}: {len(self.ops)} ops, "
                f"{len(self.inputs)} inputs>")

    def canonical_text(self) -> str:
        """Renumbered rendering for hashing: value ids by first appearance,
        constants as content digests, arguments through
        canonical_attr_text; identical programs captured in different
        processes give identical text."""
        renum: dict[int, int] = {}

        def rn(v: Value) -> str:
            n = renum.setdefault(id(v), len(renum))
            return f"%{n}:{v.type_str}"

        lines = ["in " + ", ".join(rn(v) for v in self.inputs)]
        for v, c in self.constants.items():
            lines.append(f"{rn(v)} = const {canonical_attr_text(c)}")
        for op in self.ops:
            ins = ", ".join(rn(v) for v in op.inputs)
            outs = ", ".join(rn(v) for v in op.outputs)
            lines.append(f"{outs} = {op.name}({ins}) {op.attr_text()}")
        lines.append("out " + ", ".join(rn(v) for v in self.outputs))
        return "\n".join(lines)

    def canonical_hash(self) -> str:
        return hashlib.sha256(self.canonical_text().encode()).hexdigest()
