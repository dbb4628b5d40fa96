"""Collective-bearing op tags for the PIR scheduler.

reference: paddle_tpu/ops/collectives.py. The collective-overlap pass
(pir/overlap.py) and the CostModel's exposed-communication term
(pir/analysis.py) need to know which ops move bytes over the interconnect
rather than HBM. A captured port program is aten (`make_fx`), and its
collectives are the `_c10d_functional` ops that
`torch.distributed._functional_collectives` dispatches: `make_fx` on fake
tensors records `_c10d_functional.all_reduce.default` and the
`wait_tensor.default` that consumes it, with the group as a name, so no
process group is needed to capture them.

Traffic factors approximate ring-algorithm bytes on the wire per payload
byte, as the reference's: an all-reduce moves about 2x the buffer
(reduce-scatter then all-gather), the one-phase collectives about 1x, a
broadcast or one-hop permute (which the functional API runs as an
`all_to_all_single`) exactly one hop. The factor multiplies the LARGER of
the op's input and output bytes, so gather-like ops are priced on their
wide side. A `pt.*` op with a region (`fn.body`) is walked like the
reference's nested jaxprs, trips 1: the port's captures have no loops.

`wait_tensor` is not a collective: it costs nothing, and it is where the
collective's result is consumed, so the overlap window of a collective
runs to the first consumer of its wait's result (`consumers_through_wait`
says which values those are).

The port's eager collectives (distributed/collective.py) are not captured
collectives. In a world of one they are the identity and record no op; in
a multi-process world they call `torch.distributed`'s in-place c10d ops
(`c10d.allgather_`, `c10d.broadcast_`), whose arguments hold a
ProcessGroup object and whose result holds a Work, which the capture
rejects (`compile_flat` then runs the function as written, under
`pir_fallback_total{stage="capture"}`).
"""

from __future__ import annotations

import math

__all__ = ["COLLECTIVE_OPS", "collective_traffic", "is_collective_op",
           "is_wait_op", "consumers_through_wait"]

# closed registry: `_c10d_functional` op name -> ring traffic factor
# (interconnect bytes per payload byte)
COLLECTIVE_OPS = {
    "all_reduce": 2.0,              # reduce-scatter + all-gather
    "all_reduce_": 2.0,
    "all_reduce_coalesced": 2.0,
    "all_reduce_coalesced_": 2.0,
    "all_gather_into_tensor": 1.0,
    "all_gather_into_tensor_out": 1.0,
    "all_gather_into_tensor_coalesced": 1.0,
    "reduce_scatter_tensor": 1.0,
    "reduce_scatter_tensor_coalesced": 1.0,
    "all_to_all_single": 1.0,       # also the functional permute: one hop
    "broadcast": 1.0,
    "broadcast_": 1.0,
}

_NAMESPACE = "_c10d_functional"
_MAX_DEPTH = 8


def _name(op):
    """(namespace, op name) of a captured op, or None for a pt op."""
    t = op.target
    if t is None:
        return None
    return t.namespace, t.overloadpacket.__name__


def _value_bytes(values):
    return float(sum(v.dtype.itemsize * math.prod(v.shape) for v in values))


def is_collective_op(op) -> bool:
    name = _name(op)
    return name is not None and name[0] == _NAMESPACE \
        and name[1] in COLLECTIVE_OPS


def is_wait_op(op) -> bool:
    return _name(op) == (_NAMESPACE, "wait_tensor")


def collective_traffic(eqn, depth: int = 0) -> list:
    """[(op name, wire bytes)] for every collective reachable from `eqn`,
    a pir Operation (the port's counterpart of the reference's JaxprEqn):
    the op itself, or the collectives of its region."""
    if depth > _MAX_DEPTH:          # pathological nesting: stay finite
        return []
    if eqn.target is not None:
        if not is_collective_op(eqn):
            return []
        n = _name(eqn)[1]
        payload = max(_value_bytes(eqn.inputs), _value_bytes(eqn.outputs))
        return [(n, payload * COLLECTIVE_OPS[n])]
    body = getattr(eqn.fn, "body", None)
    if body is None:
        return []
    found = []
    for sub in body[1]:
        found.extend(collective_traffic(sub, depth + 1))
    return found


def consumers_through_wait(op, users) -> list:
    """The values whose first reader ends `op`'s overlap window: its
    results, except that a result read by a `wait_tensor` stands for that
    wait's result (the wait itself consumes nothing). `users` is
    Program.users()."""
    out = []
    for o in op.outputs:
        readers = [u for u in users.get(o, ()) if u is not None]
        if any(not is_wait_op(u) for u in readers):
            out.append(o)
        for u in readers:
            if is_wait_op(u):
                out.extend(u.outputs)
    return out
