"""Cost-guided auto-fusion: producer-consumer groups with multi-output
groups and matmul epilogue absorption.

reference: paddle_tpu/pir/fuse.py (after paddle/cinn/, the reference
stack's fusion layer). The grouping, the commit criterion, the walls and
the failure contract are the reference's; the op sets are the aten ops the
port's programs are captured as.

Grouping (a dataflow walk over the users map):

* A group grows upward from a fusible ROOT op: a producer joins as an
  internal member when every user of every one of its results is in the
  group, or the result can be promoted to a group output (every external
  user sits after the splice point, the root's position; program outputs
  count as after). Pure layout plumbing (view, permute, expand, casts, ...)
  may instead join as a duplicable member: the original stays for its
  external users and the group replays a private copy. A later DCE removes
  duplicables that lost their last external user.
* One compute anchor per group: a matrix product (`mm`, `bmm`, `addmm`) or
  an existing `pt.fused_region` whose users pass the same test may join
  internally, making the group an epilogue region; growth continues
  through the anchor's producers. The anchor is never duplicated and never
  roots a group. While a sharding search scope is active no anchor joins
  (`_anchors_allowed`): the search prices a sharded contraction off the
  product ops.
* Fusible ops are elementwise math, layout plumbing and reductions. Never
  fusible: in-place, random or effect-scoped ops, `pt.*` ops other than
  this pass's own `pt.fused_region` (fusion never crosses a routed-kernel
  boundary), and ops touching sharding-annotated values.
* Groups are capped at MAX_GROUP_OPS members and MAX_GROUP_OUTS results;
  a group that would expose more re-plans without promotion. A group
  needs at least 2 members.

Commit criterion (strict): `CostModel.group_bytes_saved` (or
`epilogue_bytes_saved` for an anchored group) must predict a strict
decrease in bytes moved by one fused kernel over the group. The port has
no such kernel yet: a group's replay moves what its members move, so the
CostModel prices it at their summed traffic and the pass reports no bytes
saved; the prediction stays on the group as `predicted_bytes_saved`.

Each committed group becomes one `pt.fused_region` op whose callable
replays its members as the plain torch ops they were captured as (no
`torch.compile`), under a `record_function` named
`pir.fuse.<program>.g<id>` while the profiler runs. The op carries
`attrs["fusion_group"]`: kind (chain | multi_output | epilogue), member op
names, result count, flops and bytes (the members' own: what the replay
moves) and the predicted bytes a fused kernel would save, which the
printer shows, the canonical hash keys and `CompileReport.summary()`
counts.

Failure contract:

* per group: any failure while building one group (an injected
  `compile.fuse` fault included) skips that group; its ops run unfused,
  the other groups stay committed;
* whole pass: a failure in the planning walk (or an injected fault at the
  pass entry, hit 1) raises the typed `FusionPassError`, and
  pipeline.compile_flat runs that function as written, counted
  `pir_fallback_total{stage="fuse"}`.

Every group is verifier-gated before commit: a fake-tensor evaluation of
the fused body must re-derive exactly the stamped result types.
"""

from __future__ import annotations

import time

import torch

from .ir import Operation, Program, dtype_name
from .passes import Pass, PassResult

__all__ = ["FusionPass", "FusionPassError", "FUSIBLE_ELEMENTWISE",
           "FUSIBLE_LAYOUT", "FUSIBLE_REDUCE", "FUSIBLE_ANCHORS",
           "MAX_GROUP_OPS", "MAX_GROUP_OUTS", "GROUP_KINDS"]


class FusionPassError(RuntimeError):
    """The fuse pass failed wholesale (planning-walk bug or an injected
    `compile.fuse` fault at the pass entry). compile_flat catches this
    type and runs that function as written, under
    `pir_fallback_total{stage="fuse"}`; per-group failures never raise
    it."""


# elementwise math: one output element reads the aligned input elements
FUSIBLE_ELEMENTWISE = frozenset({
    "add", "sub", "mul", "div", "remainder", "maximum", "minimum", "pow",
    "exp", "exp2", "expm1", "log", "log1p", "tanh", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "sqrt", "rsqrt",
    "reciprocal", "sigmoid", "silu", "gelu", "relu", "erf", "erfinv",
    "erfc", "abs", "neg", "sign", "floor", "ceil", "round", "clamp",
    "clamp_min", "clamp_max", "square", "isfinite", "logical_not",
    "logical_and", "logical_or", "logical_xor", "bitwise_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "eq", "ne", "lt", "le",
    "gt", "ge", "where", "masked_fill",
})

# layout/dtype plumbing: transparent to the math, free to recompute (the
# duplicable set)
FUSIBLE_LAYOUT = frozenset({
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "unsqueeze", "squeeze", "expand", "clone", "_to_copy", "detach",
    "alias",
})

# reduce epilogues: a chain folding into a (much smaller) reduced result;
# a reduce may also sit mid-group (rmsnorm) when its consumers all fused
FUSIBLE_REDUCE = frozenset({"sum", "mean", "amax", "amin", "prod", "any",
                            "all"})

_FUSIBLE = FUSIBLE_ELEMENTWISE | FUSIBLE_LAYOUT | FUSIBLE_REDUCE

# compute anchors: at most ONE per group, never duplicated, never a root;
# "pt.fused_region" makes regions compose
FUSIBLE_ANCHORS = frozenset({"mm", "bmm", "addmm", "pt.fused_region"})

# provenance kinds a committed group may carry (closed set; bench and
# chaos key on these literals)
GROUP_KINDS = ("chain", "multi_output", "epilogue")

# group size cap: fused bodies past this stop being CSE/compile-cache
# friendly (and the greedy walk's win saturates long before it)
MAX_GROUP_OPS = 24

# result cap: a group promoting more outputs than this re-plans under
# the single-output discipline (every promoted result is an HBM
# write — past a handful the multi-output form stops paying and the
# fused-op signature stops being cache-friendly)
MAX_GROUP_OUTS = 8

# minimum members: a singleton group has identical boundary and member
# traffic — structurally refused before pricing
_MIN_GROUP_OPS = 2


class _Group:
    """One committed-candidate fusion group (planning output)."""

    __slots__ = ("root", "internal", "dups", "members", "boundary",
                 "outs", "bytes_saved", "kind", "anchor")

    def __init__(self, root, internal, dups, members, boundary, outs,
                 bytes_saved, kind="chain", anchor=None):
        self.root = root
        self.internal = internal    # [Operation] removed by the splice
        self.dups = dups            # [Operation] replayed, left in place
        self.members = members      # internal + dups, program order
        self.boundary = boundary    # [Value] fused-op operands
        self.outs = outs            # [Value] fused-op results (root's +
        #                             promoted intermediates)
        self.bytes_saved = bytes_saved
        self.kind = kind            # chain | multi_output | epilogue
        self.anchor = anchor        # the absorbed compute op, or None


class FusionPass(Pass):
    """Cost-guided producer-consumer auto-fusion (module docstring has
    the full contract)."""

    name = "fuse"

    def __init__(self, cost_model=None):
        if cost_model is None:
            from .analysis import CostModel
            cost_model = CostModel()
        self.cost = cost_model

    # -- fusibility ---------------------------------------------------------
    @staticmethod
    def _fusible(op: Operation) -> bool:
        if op.target is None or op.fn is not None:
            return False            # pt.* dispatch ops are walls
        if op.target.overloadpacket.__name__ not in _FUSIBLE:
            return False
        if op.has_effects() or op.attrs.get("effect") is not None:
            return False            # in-place / random / paged-KV order
        # annotated dataflow stays op-granular so the sharding passes see
        # every annotation conflict and propagation frontier
        return not any(v.sharding is not None
                       for vs in (op.inputs, op.outputs) for v in vs)

    @staticmethod
    def _anchor_fusible(op: Operation) -> bool:
        """May `op` be absorbed as a group's compute anchor? A matrix
        product or one of this pass's own pt.fused_region ops, with the
        sharding and effect walls as for regular members."""
        name = op.name if op.target is None \
            else op.target.overloadpacket.__name__
        if name not in FUSIBLE_ANCHORS:
            return False
        if op.has_effects() or op.attrs.get("effect") is not None:
            return False
        if any(v.sharding is not None
               for vs in (op.inputs, op.outputs) for v in vs):
            return False            # sharded values are a hard wall
        return op.fn is not None if op.target is None else True

    @staticmethod
    def _value_bytes(values) -> float:
        from .analysis import _value_bytes
        return _value_bytes(values)

    # -- planning (no mutation) ---------------------------------------------
    def _plan(self, prog: Program) -> list:
        users = prog.users()
        index = {id(op): i for i, op in enumerate(prog.ops)}
        from .passes import mutated_storage
        touches = mutated_storage(prog)
        # ops reading or writing a buffer an in-place op writes keep their
        # place in program order: they never join a group
        claimed: set[int] = {id(op) for op in prog.ops if touches(op)}
        anchors_ok = self._anchors_allowed()
        plans = []
        for root in reversed(prog.ops):
            if id(root) in claimed or not self._fusible(root):
                continue
            g = self._grow(prog, root, users, claimed, index,
                           anchors_ok=anchors_ok)
            if g is not None and len(g.outs) > MAX_GROUP_OUTS:
                # too many promoted results: re-plan this root under the
                # single-output discipline (never worse than without
                # promotion)
                g = self._grow(prog, root, users, claimed, index,
                               promote=False, anchors_ok=anchors_ok)
            if g is None:
                continue
            # claim EVERY member — dups included. A dup stays in the
            # program, but if a later-planned group were allowed to
            # absorb it internally, that group would also internalize
            # (and remove) the dup's producers, dangling this group's
            # boundary reads of those producers' outputs.
            claimed.update(id(op) for op in g.members)
            plans.append(g)
        plans.reverse()             # program order -> deterministic gids
        return plans

    @staticmethod
    def _anchors_allowed() -> bool:
        """Epilogue absorption is off while a sharding search scope is
        active (reference :278-292): the search prices the implied
        all-reduce of a sharded contraction off the matrix-product ops
        (shard_search.predict_seconds), so a product absorbed into an
        opaque region would hide that term. The chains around products
        still fuse."""
        from . import shard_prop as _sp
        return not (_sp.current_mesh() is not None
                    and _sp.current_search())

    def _grow(self, prog, root, users, claimed, index, promote=True,
              anchors_ok=True):
        internal: dict[int, Operation] = {id(root): root}
        dups: dict[int, Operation] = {}
        anchor: list = [None]       # at most one compute anchor
        root_idx = index[id(root)]

        def absorbable(p):
            return (id(p) not in internal and id(p) not in dups
                    and id(p) not in claimed)

        def users_ok(p):
            # internal absorption legality: every user of every result
            # is in-group, or the result is promotable — every external
            # user sits AFTER the splice point (the root's position), so
            # the fused op still defines it before its first read.
            # Program outputs (the None sentinel) are always-after.
            # Without promotion (the re-plan) external users refuse.
            for o in p.outputs:
                for u in users.get(o, ()):
                    if u is not None and id(u) in internal:
                        continue
                    if not promote:
                        return False
                    if u is not None and index.get(id(u), -1) <= root_idx:
                        return False
            return True

        changed = True
        while changed and len(internal) + len(dups) < MAX_GROUP_OPS:
            changed = False
            frontier = list(internal.values()) + list(dups.values())
            for op in frontier:
                for v in op.inputs:
                    p = v.op
                    if p is None or not absorbable(p):
                        continue
                    if len(internal) + len(dups) >= MAX_GROUP_OPS:
                        break
                    if self._fusible(p) and users_ok(p):
                        internal[id(p)] = p
                        changed = True
                    elif self._fusible(p) \
                            and p.target.overloadpacket.__name__ \
                            in FUSIBLE_LAYOUT \
                            and self._value_bytes(p.inputs) \
                            <= self._value_bytes(p.outputs):
                        # duplicable: replay privately, original stays
                        # for its external users (DCE reaps it later if
                        # they disappear). The byte guard keeps e.g. a
                        # downcast's wide input off the fused boundary.
                        dups[id(p)] = p
                        changed = True
                    elif anchors_ok and anchor[0] is None \
                            and self._anchor_fusible(p) and users_ok(p):
                        # epilogue absorption: the compute anchor joins
                        # internally (never duplicated — users_ok means
                        # no pre-splice external reader needs the
                        # original), and growth continues through its
                        # producers
                        internal[id(p)] = p
                        anchor[0] = p
                        changed = True

        member_ids = set(internal) | set(dups)
        if len(member_ids) < _MIN_GROUP_OPS:
            return None
        members = [op for op in prog.ops if id(op) in member_ids]
        internal_ordered = [op for op in members if id(op) in internal]
        dups_ordered = [op for op in members if id(op) in dups]
        boundary, seen = [], set()
        for op in members:
            for v in op.inputs:
                if v.op is not None and id(v.op) in member_ids:
                    continue        # computed inside the replay
                if id(v) not in seen:
                    seen.add(id(v))
                    boundary.append(v)
        # group results: every internal result some non-member still
        # reads (or a program output) is promoted, in program order —
        # the root's live results plus any sibling-shared intermediate
        outs = []
        for op in internal_ordered:
            for o in op.outputs:
                if any(u is None or id(u) not in internal
                       for u in users.get(o, ())):
                    outs.append(o)
        if not outs:
            return None             # fully dead group: DCE's job, not ours
        if anchor[0] is not None:
            kind = "epilogue"
            saved = self.cost.epilogue_bytes_saved(
                anchor[0], internal_ordered, boundary, outs)
        else:
            kind = "multi_output" if len(outs) > 1 else "chain"
            saved = self.cost.group_bytes_saved(internal_ordered,
                                                boundary, outs)
        if saved <= 0:
            return None             # strict decrease or no commit
        return _Group(root, internal_ordered, dups_ordered, members,
                      boundary, outs, saved, kind=kind, anchor=anchor[0])

    # -- commit (one mutation at the end; fallible work first) --------------
    def _commit(self, prog: Program, gid: int, g: _Group,
                mode=None) -> Operation:
        from .analysis import fake_eval_fn
        boundary, outs, members = g.boundary, g.outs, g.members
        out_ids = [id(v) for v in outs]
        scope = f"pir.fuse.{prog.name}.g{gid}"

        def body(args):
            env = {}
            for v, a in zip(boundary, args):
                env[id(v)] = a
            for op in members:
                ins = [env[id(v)] for v in op.inputs]
                for v, o in zip(op.outputs, op.evaluate(ins)):
                    env[id(v)] = o
            return tuple(env[i] for i in out_ids)

        def fused_region(*args):
            if not torch.autograd._profiler_enabled():
                return body(args)
            with torch.autograd.profiler.record_function(scope):
                return body(args)

        fused_region.__name__ = f"fused_region_g{gid}"
        fused_region.body = (list(boundary), list(members), list(outs), {})
        fn = fused_region

        # per-group verifier gate: the fused body must abstractly re-derive
        # exactly the stamped result types, so a bad group falls back alone
        derived = fake_eval_fn(fn, boundary, mode=mode)
        if derived is None or len(derived) != len(outs):
            raise RuntimeError(f"fused group g{gid} does not re-derive its "
                               f"{len(outs)} results")
        for v, d in zip(outs, derived):
            if d != (tuple(v.shape), dtype_name(v.dtype)):
                raise RuntimeError(
                    f"fused group g{gid} result %{v.vid} derives "
                    f"{d[1]}[{','.join(map(str, d[0]))}], stamped "
                    f"{v.type_str}")

        # roofline provenance: the region replays its members op by op,
        # so its flops and its traffic are theirs; the boundary traffic
        # is what a fused kernel would move (predicted_bytes_saved)
        costs = [self.cost._op_cost(op) for op in members]
        flops = sum(c.flops for c in costs)
        replay_bytes = sum(c.bytes for c in costs)
        new_op = Operation(
            "pt.fused_region", list(boundary), outs,
            attrs={"fusion_group": {
                "id": gid,
                "kind": g.kind,
                "ops": [op.name for op in members],
                "outs": len(outs),
                "flops": float(flops),
                "bytes": float(replay_bytes),
                "predicted_bytes_saved": int(g.bytes_saved)}},
            fn=fn)
        prog.replace_region(g.internal, new_op)
        return new_op

    # -- the pass -----------------------------------------------------------
    def run(self, prog: Program) -> PassResult:
        from ..observability import span as _span
        from ..observability.catalog import metric as _metric
        from ..resilience.faults import fault_point
        t0 = time.perf_counter()
        committed = skipped = member_ops = 0
        predicted_total = 0.0
        kinds = {k: 0 for k in GROUP_KINDS}
        with _span("pir.fuse", program=prog.name, ops=len(prog.ops)):
            try:
                # hit 1 of the chaos seam: a fault HERE (or any planning
                # bug) is a whole-pass failure -> stage="fuse" fallback
                fault_point("compile.fuse", program=prog.name,
                            where="pass")
                plans = self._plan(prog)
            except Exception as e:  # noqa: BLE001 — typed for the pipeline
                raise FusionPassError(
                    f"fuse planning failed for {prog.name!r}: "
                    f"{type(e).__name__}: {e}") from e
            from .analysis import fake_mode
            mode = fake_mode()
            for gid, g in enumerate(plans):
                try:
                    # hits 2..N+1: per-group seam — a fault here skips
                    # THIS group only (its ops replay unfused)
                    fault_point("compile.fuse", program=prog.name,
                                group=gid)
                    self._commit(prog, gid, g, mode)
                except Exception:  # noqa: BLE001 — per-group fallback:
                    skipped += 1   # nothing was mutated for this group
                    continue
                committed += 1
                member_ops += len(g.members)
                predicted_total += g.bytes_saved
                kinds[g.kind] += 1
        dt = time.perf_counter() - t0
        try:
            _metric("pir_fuse_seconds").observe(dt)
            if committed:
                _metric("pir_fusion_groups_total",
                        program=prog.name).inc(committed)
                # a replayed region spares the card no bytes
                _metric("pir_fusion_bytes_saved",
                        program=prog.name).inc(0)
                for k, n in kinds.items():
                    if n:
                        _metric("pir_fusion_groups_by_kind_total",
                                program=prog.name, kind=k).inc(n)
        except Exception:  # noqa: BLE001 — metrics never cost a compile
            pass
        prog._fusion = {"groups": committed,
                        "bytes_saved": 0,
                        "predicted_bytes_saved": int(predicted_total),
                        "skipped": skipped,
                        "kinds": {k: n for k, n in kinds.items() if n}}
        notes = (f"groups={committed} member_ops={member_ops} "
                 f"bytes_saved=0 "
                 f"predicted_bytes_saved={int(predicted_total)}")
        if committed:
            notes += " kinds=" + ",".join(
                f"{k}:{n}" for k, n in kinds.items() if n)
        if skipped:
            notes += f" skipped={skipped}"
        return PassResult(committed, notes)
