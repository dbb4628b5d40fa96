"""Collective-overlap scheduling pass: hide communication under compute.

reference: paddle_tpu/pir/overlap.py (Tile-Level Activation Overlap,
arXiv:2607.02521, and the overlap half of Operator Fusion in XLA,
arXiv:2301.13062), at PIR granularity. Collective-bearing ops
(ops/collectives.py: the `_c10d_functional` collectives) are hoisted to
the earliest position their operands allow, which widens the window
between a collective's issue and the first consumer of its result (read
through its `wait_tensor`, which stays where it was). Independent compute
in that window earns overlap credit in the CostModel's
exposed-communication term; the pass commits a reorder only if that term
strictly decreases, otherwise it restores the captured order and reports
zero edits.

Legality: an op moves only earlier, to a slot after the definitions of all
its operands. Effectful ops (in-place, random, effect-scoped) never move
and are barriers nothing hoists across, and no op is hoisted across an op
that reads or writes a buffer an in-place op of the program writes
(`passes.mutated_storage`, as fold and CSE use it), so program order stays
what it was for every mutated buffer. Reordering pure ops is
semantics-free in the replay.
"""

from __future__ import annotations

from .analysis import CostModel
from .ir import Program
from .passes import Pass, PassResult, mutated_storage

__all__ = ["CollectiveOverlap"]

# relative improvements smaller than this are noise, not a schedule win
_MIN_GAIN = 1e-12


def _effectful(op) -> bool:
    return op.has_effects() or bool(op.attrs and op.attrs.get("effect"))


class CollectiveOverlap(Pass):
    name = "overlap"

    def __init__(self, cost_model=None):
        self.cost = cost_model or CostModel()

    def run(self, prog: Program) -> PassResult:
        if not any(self.cost.comm_seconds(op) > 0.0 for op in prog.ops):
            return PassResult(0, "no-collectives")
        before = self.cost.exposed_comm_seconds(prog)["exposed_seconds"]
        original = list(prog.ops)
        moves = self._hoist(prog)
        if not moves:
            return PassResult(0, f"exposed={before:.3g}s moves=0")
        after = self.cost.exposed_comm_seconds(prog)["exposed_seconds"]
        if after >= before - _MIN_GAIN * max(1.0, before):
            prog.ops = original     # no strict win: keep the captured order
            return PassResult(0, f"exposed={before:.3g}s moves=0 "
                                 f"(reorder not profitable)")
        try:
            from ..observability.catalog import metric as _metric
            _metric("pir_exposed_comm_seconds",
                    program=prog.name).set(after)
        except Exception:  # noqa: BLE001 — metrics never cost a compile
            pass
        return PassResult(
            moves, f"exposed {before:.3g}s -> {after:.3g}s moves={moves}")

    def _hoist(self, prog: Program) -> int:
        """Move each collective-bearing pure op to the earliest legal index:
        after every operand's definition and after the last preceding
        barrier. One left-to-right sweep; taking an op out and putting it
        back earlier keeps every other relative order."""
        touches = mutated_storage(prog)
        moves = 0
        i = 0
        while i < len(prog.ops):
            op = prog.ops[i]
            if self.cost.comm_seconds(op) <= 0.0 or _effectful(op) \
                    or touches(op):
                i += 1
                continue
            deps = {id(v) for v in op.inputs}
            earliest = 0
            for j in range(i - 1, -1, -1):
                prev = prog.ops[j]
                if _effectful(prev) or touches(prev) \
                        or any(id(o) in deps for o in prev.outputs):
                    earliest = j + 1
                    break
            if earliest < i:
                prog.ops.pop(i)
                prog.ops.insert(earliest, op)
                moves += 1
            i += 1
        return moves
