"""Dataflow analyses and the static cost model over pir.Program.

reference: paddle_tpu/pir/analysis.py — the join-semilattice worklist
engine (`Lattice`, `FlatLattice`, `DataflowAnalysis`), `ShapeDtypeInference`,
`Liveness` with `check_donation_safety`, `ShardingConsistency` and the
`CostModel` (:329-636), plus the serving engine's pricer `price`
(`OpCost` and `ProgramCost` :436-465, the per-equation rule `_eqn_cost`
:394-422, `DEFAULT_ROOFLINE` :329).

Programs are topologically ordered straight-line SSA, so each fixpoint
converges in one sweep; the engine still re-enqueues dependents so transfer
functions need no ordering assumptions.

* `ShapeDtypeInference` re-derives every Value's (shape, dtype) from the
  program's inputs and constants by running each op on fake tensors
  (`FakeTensorMode`): captured ops through their aten meta functions, the
  registered K1/K2 operators through their fake kernels
  (ops/flash_attention.py), `pt.*` ops through their callables. It backs
  the verifier's type-mismatch rule.
* `Liveness` (backward) and `check_donation_safety`: a donated input read
  again after an in-place op overwrote its buffer.
* `ShardingConsistency`: optional `Value.sharding` annotations propagate
  over a FlatLattice and report conflicts.
* `CostModel` prices every op by the rule below and folds the prices into
  a `ProgramCost` with a roofline time.

The pricing rule (`price` applies it without the attention line, as
before the PIR slice):

  - `mm`, `bmm`, `addmm`, `baddbmm` and `matmul` cost 2 * out * K flops;
  - `convolution` costs 2 * out * (in / groups * prod(kernel)) flops, or
    2 * input * (out / groups * prod(kernel)) transposed, as XLA's cost
    analysis counts it (the reference's jaxpr rule takes 10 * out, an
    elementwise floor for an op the Llama stack never emits;
    hapi.flops counts convolutions by this one);
  - in `CostModel`, the flash-attention operators K1 and K2 (and the
    `pt.sdpa` ops) cost
    4 * BH * Sq * Sk * D flops, half that when causal: the two products
    the kernel does (the reference prices its pallas call by its
    elementwise floor, which hides the attention's arithmetic);
  - any other op costs its output elements;
  - bytes are the op's tensor inputs plus its outputs;
  - raw_seconds = max(flops / (peak * efficiency), bytes / hbm_bps).

One departure: an op that returns a view (`OpOverload.is_view`: view,
select, transpose, permute, expand, ...) is free. It moves no byte and does
no arithmetic, and the port's Python loop over layers selects each layer's
slice of the KV pool, where the reference's scan slices it implicitly:
priced by the rule, that select alone would charge the whole pool's bytes
to every layer.

`price` runs a program once under a `TorchDispatchMode` and prices every
aten op that reaches the dispatcher (the serving engine's calibrated
dispatch pricer); `CostModel` prices a captured Program from its stamped
value types without running it.

`DEFAULT_ROOFLINE` holds the H100's own bounds: 989e12 FLOP/s of dense
bf16 and 3.35e12 B/s of HBM, with efficiency 1.0, because the engine's
calibration (its first measured dispatch sets the scale) absorbs the rest.
The mode only reads shapes and dtypes, so pricing a CUDA program adds no
synchronisation.

The communication terms (reference :341-344, :575-634): a collective
(ops/collectives.py) costs wire_bytes / ici_bps + link_latency_s seconds
on `DEFAULT_INTERCONNECT`, the H100 SXM's NVLink row; the compute ops
scheduled between a collective and the first consumer of its result (of
its `wait_tensor`'s result) earn overlap credit, and what the credit does
not cover is exposed (`exposed_comm_seconds`, the objective of
pir/overlap.py). `wait_tensor` costs nothing.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.collectives import (collective_traffic, consumers_through_wait,
                               is_wait_op)

__all__ = ["Lattice", "FlatLattice", "DataflowAnalysis",
           "ShapeDtypeInference", "Liveness", "ShardingConsistency",
           "DonationHazard", "check_donation_safety", "CONFLICT",
           "CostModel", "OpCost", "ProgramCost", "DEFAULT_ROOFLINE",
           "DEFAULT_INTERCONNECT", "price", "aligned_spec",
           "broadcast_result_shape", "join_broadcast"]

DEFAULT_ROOFLINE = {
    "peak_flops": 989e12,
    "efficiency": 1.0,
    "hbm_bps": 3.35e12,
}

# The interconnect row, under the reference's keys. ici_bps is NVIDIA's
# data-sheet figure for the H100 SXM's NVLink, 900 GB/s to the other cards
# of the host, 4.5e11 B/s each way: a data-sheet number, not a
# measurement, since one card has no link to measure. No data sheet gives
# a per-collective latency and one card cannot measure it, so the term is
# 0.0 until a run across cards does (ROADMAP Queue 1 item 4).
DEFAULT_INTERCONNECT = {
    "ici_bps": 4.5e11,
    "link_latency_s": 0.0,
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
    calls)], heaviest first. ``comm_seconds`` is the interconnect time of
    the program's collectives (0.0 for a program without one) and
    ``exposed_comm_seconds`` what overlap credit did not hide."""

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

    def summary(self):
        out = {"name": self.name, "flops": self.flops,
               "bytes": self.bytes, "raw_seconds": self.raw_seconds,
               "top_ops": [(n, c.flops, c.bytes)
                           for n, c in self.per_op[:5]]}
        if self.comm_seconds:
            out["comm_seconds"] = self.comm_seconds
            out["exposed_comm_seconds"] = self.exposed_comm_seconds
        return out

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


# --------------------------------------------------------------------------
# the dataflow engine
# --------------------------------------------------------------------------

class _Conflict:
    """Lattice top: irreconcilable facts met."""

    def __repr__(self):
        return "<CONFLICT>"


CONFLICT = _Conflict()


class Lattice:
    """Join-semilattice interface: `bottom` (no information) joined upward
    toward CONFLICT (contradictory information)."""

    def bottom(self):
        return None

    def join(self, a, b):  # pragma: no cover - interface
        raise NotImplementedError


class FlatLattice(Lattice):
    """bottom (None) < any concrete fact < CONFLICT; two distinct concrete
    facts join to CONFLICT."""

    def join(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if a is CONFLICT or b is CONFLICT:
            return CONFLICT
        return a if a == b else CONFLICT


class DataflowAnalysis:
    """Worklist fixpoint over a Program's op list. Subclasses set
    `direction` ("forward" | "backward") and implement `boundary(prog)`
    (seed facts) and `transfer(op, facts)`, which updates `facts` in place
    and returns True when anything changed. `run` returns the facts."""

    direction = "forward"
    name = "analysis"

    def boundary(self, prog) -> dict:
        return {}

    def transfer(self, op, facts: dict) -> bool:
        raise NotImplementedError  # pragma: no cover - interface

    def run(self, prog) -> dict:
        facts = self.boundary(prog)
        forward = self.direction == "forward"
        order = prog.ops if forward else list(reversed(prog.ops))
        users = prog.users()
        dependents: dict[int, list] = {}
        for op in prog.ops:
            if forward:
                deps = [u for o in op.outputs for u in users.get(o, ())
                        if u is not None]
            else:
                deps = [v.op for v in op.inputs if v.op is not None]
            dependents[id(op)] = deps
        worklist = deque(order)
        queued = {id(op) for op in order}
        steps = 0
        budget = max(16, len(prog.ops)) * 8    # straight-line: 1 sweep;
        while worklist:                        # the budget guards bad
            op = worklist.popleft()            # transfer functions
            queued.discard(id(op))
            steps += 1
            if steps > budget:
                raise RuntimeError(
                    f"dataflow analysis {self.name!r} did not converge "
                    f"on {prog.name!r} within {budget} steps")
            if self.transfer(op, facts):
                for dep in dependents.get(id(op), ()):
                    if id(dep) not in queued:
                        worklist.append(dep)
                        queued.add(id(dep))
        return facts


# --------------------------------------------------------------------------
# shape/dtype inference
# --------------------------------------------------------------------------

def _torch_dtype(name):
    return getattr(torch, str(name).removeprefix("torch."))


def fake_mode():
    """A FakeTensorMode for abstract evaluation; one per analysis run, as
    making one costs milliseconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def fake_eval_fn(fn, values, types=None, mode=None):
    """[(shape, dtype name)] of `fn`'s results on fake tensors shaped like
    `values` (or like `types` [(shape, dtype name)] on the values'
    devices), under `mode` (a fresh fake mode when None), or None when
    `fn` cannot be evaluated abstractly."""
    from .ir import dtype_name
    if types is None:
        types = [(v.shape, dtype_name(v.dtype)) for v in values]
    try:
        with mode if mode is not None else fake_mode():
            ins = [torch.empty(shape, dtype=_torch_dtype(dt),
                               device=v.device or "cpu")
                   for (shape, dt), v in zip(types, values)]
            outs = fn(*ins)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        return [(tuple(o.shape), dtype_name(o.dtype)) for o in outs]
    except Exception:  # noqa: BLE001 — an un-abstractable op opts out
        return None


class ShapeDtypeInference(DataflowAnalysis):
    """facts: id(Value) -> (shape tuple, dtype name). Inputs and constants
    seed from their stamped types (the program boundary is trusted); every
    op re-derives its results by running on fake tensors (cached per op).
    The verifier compares these facts with the stamped Value types (rule
    type-mismatch)."""

    direction = "forward"
    name = "shape_dtype"

    def __init__(self):
        self._cache: dict[int, Optional[list]] = {}
        self._mode = fake_mode()

    @staticmethod
    def _key(shape, dtype):
        from .ir import dtype_name
        return (tuple(shape), dtype_name(dtype))

    def boundary(self, prog) -> dict:
        return {id(v): self._key(v.shape, v.dtype)
                for v in list(prog.inputs) + list(prog.constants)}

    def derived_out_types(self, op, facts: dict):
        """[(shape, dtype name)] for op's outputs, or None (underived).
        An op keeps its last derivation (`Operation._types`) for the same
        operand types, argument template and callable, so the verifier's
        run after the passes re-derives only the ops they made or
        rewired."""
        cached = self._cache.get(id(op), False)
        if cached is not False:
            return cached
        types = [facts[id(v)] for v in op.inputs]
        memo = op._types
        if memo is not None and memo[0] == types and memo[1] is op.spec \
                and memo[2] is op.fn:
            derived = memo[3]
        else:
            derived = fake_eval_fn(lambda *a: op.evaluate(list(a)),
                                   op.inputs, types, mode=self._mode)
            op._types = (types, op.spec, op.fn, derived)
        self._cache[id(op)] = derived
        return derived

    @staticmethod
    def derived_in_types(op):
        """The operand types a captured op was captured with (None for pt
        ops, whose operands are not pinned)."""
        return op.in_types

    def transfer(self, op, facts: dict) -> bool:
        if any(id(v) not in facts for v in op.inputs):
            return False            # operands not yet derived
        derived = self.derived_out_types(op, facts)
        if derived is None or len(derived) != len(op.outputs):
            derived = [self._key(o.shape, o.dtype) for o in op.outputs]
        changed = False
        for v, d in zip(op.outputs, derived):
            if facts.get(id(v)) != d:
                facts[id(v)] = d
                changed = True
        return changed


# --------------------------------------------------------------------------
# liveness + donation safety
# --------------------------------------------------------------------------

class Liveness(DataflowAnalysis):
    """Backward liveness: facts map ("after", i) and ("before", i) (op
    index) to the frozenset of Value ids live after/before op i, seeded
    from the program outputs; `uses` and `last_use` index maps too."""

    direction = "backward"
    name = "liveness"

    def __init__(self):
        self.index: dict[int, int] = {}
        self.uses: dict[int, list[int]] = {}
        self.last_use: dict[int, int] = {}

    def boundary(self, prog) -> dict:
        self.index = {id(op): i for i, op in enumerate(prog.ops)}
        self.uses = {}
        for i, op in enumerate(prog.ops):
            for v in op.inputs:
                self.uses.setdefault(id(v), []).append(i)
        self.last_use = {vid: idxs[-1] for vid, idxs in self.uses.items()}
        out_live = frozenset(id(v) for v in prog.outputs)
        n = len(prog.ops)
        facts = {("after", n - 1): out_live} if n else {}
        facts["exit"] = out_live
        return facts

    def transfer(self, op, facts: dict) -> bool:
        i = self.index[id(op)]
        live_after = facts.get(("after", i), frozenset())
        live_before = (live_after - {id(o) for o in op.outputs}) \
            | {id(v) for v in op.inputs}
        changed = False
        if facts.get(("before", i)) != live_before:
            facts[("before", i)] = live_before
            changed = True
        if i > 0:
            prev = facts.get(("after", i - 1), frozenset())
            merged = prev | live_before
            if merged != prev:
                facts[("after", i - 1)] = merged
                changed = True
        return changed


def _overwrites(op) -> bool:
    """An in-place op: its schema mutates an argument's buffer (the
    port's counterpart of the reference's dynamic_update_slice/scatter
    shapes, which XLA folds a donated input into)."""
    return op.target is not None and op.target._schema.is_mutable


class DonationHazard:
    __slots__ = ("value", "overwrite_op", "overwrite_index", "use_index")

    def __init__(self, value, overwrite_op, overwrite_index, use_index):
        self.value = value
        self.overwrite_op = overwrite_op
        self.overwrite_index = overwrite_index
        self.use_index = use_index

    def __repr__(self):
        return (f"DonationHazard(%{self.value.vid} overwritten by "
                f"{self.overwrite_op.name!r} at op {self.overwrite_index}, "
                f"read again at op {self.use_index})")


def check_donation_safety(prog, donate_argnums) -> list:
    """A donated program input overwritten in place by an op whose result
    has the input's type, and then read again later: the second read
    would see the overwritten buffer. Returns [DonationHazard]; empty is
    safe."""
    lv = Liveness()
    lv.run(prog)
    hazards = []
    for argnum in donate_argnums or ():
        if argnum >= len(prog.inputs):
            continue
        d = prog.inputs[argnum]
        use_idxs = lv.uses.get(id(d), [])
        if len(use_idxs) < 2:
            continue                    # single consumer: trivially safe
        for i in use_idxs:
            op = prog.ops[i]
            if not _overwrites(op):
                continue
            dkey = (tuple(d.shape), str(d.dtype))
            if not any((tuple(o.shape), str(o.dtype)) == dkey
                       for o in op.outputs):
                continue
            later = [j for j in use_idxs if j > i]
            if later:
                hazards.append(DonationHazard(d, op, i, later[0]))
                break
    return hazards


# --------------------------------------------------------------------------
# the static cost model
# --------------------------------------------------------------------------

_ATTENTION_OPS = ("flash_fwd", "flash_fwd_rms_epilogue")


def _numel(shape):
    return math.prod(int(d) for d in shape)


def _value_bytes(values):
    return float(sum(_numel(v.shape) * v.dtype.itemsize for v in values))


def _attention_flops(bh, sq, sk, d, causal):
    return 4.0 * bh * sq * sk * d * (0.5 if causal else 1.0)


def _captured_cost(op):
    """(flops, bytes) of a captured op by the module's rule."""
    t = op.target
    if t.is_view or is_wait_op(op):
        return 0.0, 0.0
    nbytes = _value_bytes(op.inputs) + _value_bytes(op.outputs)
    name = t.overloadpacket.__name__
    args, _ = op.spec
    k_arg = _PRODUCT_K_ARG.get(name)
    if k_arg is not None and op.outputs:
        k = op.inputs[args[k_arg].i].shape[-1]
        return 2.0 * _numel(op.outputs[0].shape) * k, nbytes
    if name == "convolution":
        x, w = op.inputs[args[0].i], op.inputs[args[1].i]
        src = x if args[6] else op.outputs[0]
        return 2.0 * _numel(src.shape) * _numel(w.shape[1:]), nbytes
    if name in _ATTENTION_OPS:
        bh, sq, d = op.inputs[args[0].i].shape
        sk = op.inputs[args[1].i].shape[1]
        causal = args[5] if name == "flash_fwd_rms_epilogue" else args[3]
        return _attention_flops(bh, sq, sk, d, causal), nbytes
    return float(sum(_numel(o.shape) for o in op.outputs)), nbytes


class CostModel(DataflowAnalysis):
    """Forward pricing pass: facts map id(op) -> OpCost from the op's
    stamped operand and result types. Fused regions carry their members'
    summed flops over the fused boundary bytes; `pt.sdpa*` ops price as
    attention; any other pt op is priced memory-bound (2 flops an output
    element). `analyze` folds the facts into a ProgramCost with the
    roofline time t = max(flops / (peak * eff), bytes / hbm_bps)."""

    direction = "forward"
    name = "cost"

    def __init__(self, roofline=None, interconnect=None):
        self.roofline = dict(DEFAULT_ROOFLINE)
        if roofline:
            self.roofline.update(roofline)
        self.interconnect = dict(DEFAULT_INTERCONNECT)
        if interconnect:
            self.interconnect.update(interconnect)

    _value_bytes = staticmethod(_value_bytes)

    def _op_cost(self, op) -> OpCost:
        if op.target is not None:
            try:
                return OpCost(*_captured_cost(op))
            except Exception:  # noqa: BLE001 — never fail over pricing
                pass
        fg = op.attrs.get("fusion_group")
        if isinstance(fg, dict) and "flops" in fg:
            return OpCost(float(fg["flops"]), float(fg["bytes"]))
        nbytes = _value_bytes(op.inputs) + _value_bytes(op.outputs)
        if op.name.startswith("pt.sdpa") and "shape" in op.attrs:
            b, sq, sk, h, d = op.attrs["shape"]
            return OpCost(_attention_flops(b * h, sq, sk, d,
                                           op.attrs.get("causal", False)),
                          nbytes)
        return OpCost(2.0 * sum(_numel(v.shape) for v in op.outputs),
                      nbytes)

    def transfer(self, op, facts: dict) -> bool:
        if id(op) in facts:
            return False
        facts[id(op)] = self._op_cost(op)
        return True

    def group_bytes_saved(self, members, boundary_inputs, outputs):
        """Predicted HBM bytes a fusion group saves: the unfused members'
        operand+result traffic minus the fused op's boundary traffic (each
        boundary input read once, each result written once)."""
        unfused = sum(self._op_cost(op).bytes for op in members)
        fused = _value_bytes(boundary_inputs) + _value_bytes(outputs)
        return unfused - fused

    def epilogue_bytes_saved(self, anchor, members, boundary_inputs,
                             outputs):
        """Bytes an anchored (epilogue) group saves: as group_bytes_saved,
        with the compute anchor priced by its stamped value traffic (its
        operand reads cancel against the fused op's boundary reads; what
        fusion removes is its result's round trip)."""
        chain = [op for op in members if op is not anchor]
        unfused = (sum(self._op_cost(op).bytes for op in chain)
                   + _value_bytes(anchor.inputs)
                   + _value_bytes(anchor.outputs))
        fused = _value_bytes(boundary_inputs) + _value_bytes(outputs)
        return unfused - fused

    def analyze(self, prog) -> ProgramCost:
        facts = self.run(prog)
        flops = sum(c.flops for c in facts.values())
        nbytes = sum(c.bytes for c in facts.values())
        eff_flops = self.roofline["peak_flops"] * self.roofline["efficiency"]
        raw = max(flops / eff_flops if eff_flops > 0 else 0.0,
                  nbytes / self.roofline["hbm_bps"]
                  if self.roofline["hbm_bps"] > 0 else 0.0)
        per_op: dict[str, OpCost] = {}
        for op in prog.ops:
            c = per_op.setdefault(op.name, OpCost())
            c.flops += facts[id(op)].flops
            c.bytes += facts[id(op)].bytes
        ranked = sorted(per_op.items(),
                        key=lambda nc: -(nc[1].flops + nc[1].bytes))
        comm = exposed = 0.0
        try:
            rep = self.exposed_comm_seconds(prog, facts)
            comm, exposed = rep["comm_seconds"], rep["exposed_seconds"]
        except Exception:  # noqa: BLE001 — pricing never costs a compile
            pass
        return ProgramCost(prog.name, flops, nbytes, raw, ranked,
                           comm_seconds=comm, exposed_comm_seconds=exposed)

    # -- the exposed-communication term (the interconnect row) --------------
    def comm_seconds(self, op) -> float:
        """Interconnect seconds this op spends moving bytes: every
        collective reachable from it (ops/collectives.py), priced on the
        interconnect row. 0.0 for an op without one."""
        hits = collective_traffic(op)
        if not hits:
            return 0.0
        bps = self.interconnect["ici_bps"]
        lat = self.interconnect["link_latency_s"]
        return sum(nbytes / bps + lat for _, nbytes in hits if bps > 0)

    def _compute_seconds(self, cost: OpCost) -> float:
        eff = self.roofline["peak_flops"] * self.roofline["efficiency"]
        return max(cost.flops / eff if eff > 0 else 0.0,
                   cost.bytes / self.roofline["hbm_bps"]
                   if self.roofline["hbm_bps"] > 0 else 0.0)

    def exposed_comm_seconds(self, prog, facts=None) -> dict:
        """Schedule-aware communication price of the program as ordered:
        for each collective, the compute ops scheduled between it and the
        first consumer of any of its results (read through its
        `wait_tensor`) earn overlap credit; what the credit does not cover
        is exposed. Windows are credited independently (contention
        between overlapping windows is ignored, and other collectives
        never count as credit), as the reference's."""
        if facts is None:
            facts = self.run(prog)
        comm_s = [self.comm_seconds(op) for op in prog.ops]
        compute_s = [self._compute_seconds(facts[id(op)])
                     for op in prog.ops]
        first_use: dict = {}
        for i, op in enumerate(prog.ops):
            for v in op.inputs:
                first_use.setdefault(id(v), i)
        users = prog.users() if any(c > 0.0 for c in comm_s) else {}
        total = exposed = 0.0
        n = 0
        for i, op in enumerate(prog.ops):
            if comm_s[i] <= 0.0:
                continue
            n += 1
            total += comm_s[i]
            j = min((first_use.get(id(o), len(prog.ops))
                     for o in consumers_through_wait(op, users)),
                    default=len(prog.ops))
            credit = sum(compute_s[k] for k in range(i + 1, j)
                         if comm_s[k] <= 0.0)
            exposed += max(0.0, comm_s[i] - credit)
        return {"comm_seconds": total, "exposed_seconds": exposed,
                "collectives": n}


# --------------------------------------------------------------------------
# sharding-annotation consistency
# --------------------------------------------------------------------------

def broadcast_result_shape(op):
    """The result shape of a pointwise aten op (`torch.Tag.pointwise`)
    whose operands broadcast to it and not all have it, else None. Aten
    broadcasts inside the op, where the reference's jaxpr spells the
    broadcast out as an eqn of its own: its operands' specs are joined
    right-aligned (`join_broadcast`)."""
    t = op.target
    if t is None or len(op.outputs) != 1 \
            or torch.Tag.pointwise not in t.tags:
        return None
    out = op.outputs[0].shape
    if all(v.shape == out for v in op.inputs):
        return None
    for v in op.inputs:
        if len(v.shape) > len(out) or any(
                a not in (1, b) for a, b in zip(reversed(v.shape),
                                                reversed(out))):
            return None
    return out


def aligned_spec(spec, shape, out_shape):
    """An operand's spec right-aligned to the result's rank, and the mask
    of the result dims it holds: the dims it broadcasts along (missing,
    or size 1 against more) are unsharded in the spec and False in the
    mask. Returns (spec, mask)."""
    off = len(out_shape) - len(shape)
    spec = tuple(spec)[:len(shape)] + (None,) * max(0, len(shape)
                                                     - len(spec))
    full = [None] * len(out_shape)
    mask = [False] * len(out_shape)
    for d, a in enumerate(spec):
        if shape[d] == out_shape[d + off]:
            full[d + off] = a
            mask[d + off] = True
    return tuple(full), mask


def join_broadcast(pairs, out_shape):
    """Dim by dim join of [(Value, spec)] right-aligned to `out_shape`:
    a dim an operand broadcasts along constrains nothing. CONFLICT where
    two operands disagree on a dim they both hold, or an operand's spec
    is CONFLICT."""
    res: list = [None] * len(out_shape)
    held = [False] * len(out_shape)
    for v, spec in pairs:
        if spec is CONFLICT:
            return CONFLICT
        full, mask = aligned_spec(spec, v.shape, out_shape)
        for d, keep in enumerate(mask):
            if not keep:
                continue
            if held[d] and res[d] != full[d]:
                return CONFLICT
            res[d], held[d] = full[d], True
    return tuple(res)


class ShardingConsistency(DataflowAnalysis):
    """Forward propagation of optional `Value.sharding` annotations over a
    FlatLattice: agreeing annotated operands propagate to unannotated
    outputs; disagreeing operands join to CONFLICT, which is reported once
    the op's outputs carry annotations (annotated inputs feeding a
    not-yet-propagated interior are pending constraints, not an error).
    A pointwise op's operands that broadcast to its result are joined
    right-aligned (`join_broadcast`).
    An op stamped `attrs["sharding_rule"]` is its own boundary (its
    outputs take exactly their stamped annotations), and a declared rule
    whose outputs are not all annotated is itself flagged. `conflicts`
    lists (op, detail) after `run`."""

    direction = "forward"
    name = "sharding"

    def __init__(self):
        self.lattice = FlatLattice()
        self.conflicts: list = []
        self._flagged: set[int] = set()

    @staticmethod
    def _annot(v):
        return getattr(v, "sharding", None)

    def boundary(self, prog) -> dict:
        return {id(v): self._annot(v)
                for v in list(prog.inputs) + list(prog.constants)}

    def transfer(self, op, facts: dict) -> bool:
        rule = op.attrs.get("sharding_rule") if op.attrs else None
        if rule is not None:
            if any(self._annot(o) is None for o in op.outputs) \
                    and id(op) not in self._flagged:
                self._flagged.add(id(op))
                self.conflicts.append(
                    (op, f"sharding_rule {rule!r} declared but not every "
                         f"output carries an annotation"))
            changed = False
            for o in op.outputs:
                fact = self._annot(o)
                if facts.get(id(o), None) != fact:
                    facts[id(o)] = fact
                    changed = True
            return changed
        joined = None
        bshape = broadcast_result_shape(op)
        pairs = []
        for v in op.inputs:
            fact = self.lattice.join(facts.get(id(v)), self._annot(v))
            if bshape is not None:
                if fact is not None:
                    pairs.append((v, fact))
                continue
            joined = self.lattice.join(joined, fact)
        if pairs:
            joined = join_broadcast(pairs, bshape)
        committed = any(self._annot(o) is not None for o in op.outputs)
        if joined is CONFLICT and committed and id(op) not in self._flagged:
            self._flagged.add(id(op))
            annots = [(v.vid, facts.get(id(v), self._annot(v)))
                      for v in op.inputs]
            self.conflicts.append(
                (op, f"operands carry irreconcilable shardings: "
                     f"{[(f'%{vid}', s) for vid, s in annots if s]}"))
        changed = False
        for o in op.outputs:
            fact = self.lattice.join(joined, self._annot(o))
            if fact is CONFLICT and joined is not CONFLICT \
                    and id(op) not in self._flagged:
                self._flagged.add(id(op))
                self.conflicts.append(
                    (op, f"output %{o.vid} annotated {self._annot(o)!r} "
                         f"but operands propagate {joined!r}"))
            if facts.get(id(o), None) != fact:
                facts[id(o)] = fact
                changed = True
        return changed
