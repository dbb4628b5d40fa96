"""Cost-driven sharding search: choose the sharding of a captured program.

reference: paddle_tpu/pir/shard_search.py (the ROADMAP's "Small Language
Models as Compiler Experts", arXiv:2512.19250, with the deterministic
CostModel standing in for the expert). The caller opens
`shard_prop.mesh_scope(mesh, search=[(name, flat_specs), ...])` with a
bounded strategy space (DP / TP / DP+TP input-spec lists built from the
rule tables with `shard_prop.flat_input_specs`), and this pass prices
every candidate by a dry run of the propagation fixpoint
(`propagate_facts`; the program is not mutated while searching):

  t(c) = sum_op max(flops / (eff * shards), bytes / (hbm * shards))
       + sum collectives wire_bytes / ici                  [captured]
       + sum sharded-contraction products 2 * out_bytes / ici [implied
       + sum reshard stamps out_bytes / ici                   comm]

The rates are the CostModel's rows (DEFAULT_ROOFLINE, and the NVLink
row DEFAULT_INTERCONNECT). The argmin's specs are committed to the
program inputs (shard_prop, next in the pipeline, completes the
propagation), and the decision and its predicted seconds land on the
CompileReport and in a `pir.shard_search` span. An implicit "replicated"
candidate is always priced, so the search can decide sharding is not
worth it. User annotations win: if any program input already carries a
sharding, the search declines. The space is cut to `MAX_CANDIDATES`.

A product's contracting dims are read off the aten matrix-product family
(`shard_prop.dot_operands`: mm, bmm, addmm, baddbmm), where the reference
reads dot_general's dimension numbers. The fusion pass keeps products out
of its epilogue regions while a search scope is active
(`FusionPass._anchors_allowed`), so no product hides from this term.
"""

from __future__ import annotations

import time

from . import shard_prop as _sp
from .analysis import CostModel
from .ir import Program
from .passes import Pass, PassResult

__all__ = ["ShardingSearch", "predict_seconds", "MAX_CANDIDATES"]

MAX_CANDIDATES = 16


def predict_seconds(prog: Program, facts: dict, stamps: dict,
                    mesh_axes: dict, cost: CostModel) -> float:
    """Roofline and interconnect price of one candidate assignment (facts
    and stamps from a dry `propagate_facts` run)."""
    op_costs = cost.run(prog)
    eff = cost.roofline["peak_flops"] * cost.roofline["efficiency"]
    hbm = cost.roofline["hbm_bps"]
    ici = cost.interconnect["ici_bps"]
    total = 0.0
    for op in prog.ops:
        c = op_costs[id(op)]
        shards = 1
        spec = facts.get(id(op.outputs[0])) if op.outputs else None
        if spec:
            for a in spec:
                if a is not None:
                    shards *= int(mesh_axes.get(a, 1))
        total += max(c.flops / (eff * shards) if eff > 0 else 0.0,
                     c.bytes / (hbm * shards) if hbm > 0 else 0.0)
        total += cost.comm_seconds(op)
        out_bytes = CostModel._value_bytes(op.outputs)
        dot = _sp.dot_operands(op)
        if dot is not None:
            # a sharded contraction implies an all-reduce of the result
            lhs, rhs, lc, rc = dot
            ls = facts.get(id(lhs)) or ()
            rs = facts.get(id(rhs)) or ()
            if any(d < len(ls) and ls[d] is not None for d in lc) or \
                    any(d < len(rs) and rs[d] is not None for d in rc):
                total += 2.0 * out_bytes / ici if ici > 0 else 0.0
        rule = stamps.get(id(op))
        if rule is not None and rule.startswith("reshard"):
            total += out_bytes / ici if ici > 0 else 0.0
    return total


class ShardingSearch(Pass):
    """Enumerate the scope's bounded strategy space, price each candidate
    with the CostModel, commit the argmin's input specs. Declines (0
    edits) outside a mesh scope, without a search space, or when the user
    already annotated an input."""

    name = "shard_search"

    def run(self, prog: Program) -> PassResult:
        mesh = _sp.current_mesh()
        space = _sp.current_search()
        if mesh is None or not space:
            return PassResult(0, "no-search-scope")
        if any(v.sharding is not None for v in prog.inputs):
            return PassResult(0, "user-annotated")
        mesh_axes = _sp._mesh_axis_sizes(mesh)
        cost = CostModel()
        candidates = [("replicated", None)] + list(space)[:MAX_CANDIDATES]
        from ..observability import span as _span
        from ..observability.catalog import metric as _metric
        t0 = time.perf_counter()
        priced: dict = {}
        with _span("pir.shard_search", program=prog.name,
                   candidates=len(candidates)):
            for name, specs in candidates:
                seed: dict = {}
                for v, spec in zip(prog.inputs, specs or ()):
                    if spec is not None:
                        s = _sp._sanitize(spec, v.shape, mesh_axes)
                        if s is not None:
                            seed[id(v)] = s
                facts, stamps, _, _ = _sp.propagate_facts(
                    prog, seed, cost_model=cost)
                priced[name] = (predict_seconds(prog, facts, stamps,
                                                mesh_axes, cost), specs)
        decision = min(priced, key=lambda n: (priced[n][0], n))
        predicted, specs = priced[decision]
        try:
            _metric("pir_shard_search_seconds").observe(
                time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 — metrics never cost a compile
            pass
        prog._shard_search = {
            "decision": decision,
            "predicted_seconds": predicted,
            "candidates": {n: priced[n][0] for n in sorted(priced)},
        }
        edits = 0
        if specs is not None:
            edits = _sp.annotate_inputs(prog, specs)
        return PassResult(
            edits, f"decision={decision} predicted={predicted:.3g}s "
                   f"candidates={len(priced)}")
