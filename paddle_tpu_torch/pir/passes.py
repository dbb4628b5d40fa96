"""Instrumented pass manager and the scalar optimization passes.

reference: paddle_tpu/pir/passes.py (after paddle/pir/include/pass/ and the
DCE / constant-fold / CSE passes under paddle/fluid/pir/transforms/).

Every pass run is timed into `pir_pass_seconds{pass}`, its edit count lands
in `pir_pass_edits_total{pass}` through the observability catalog, and the
pipeline is wrapped in spans. Passes are toggled through `FLAGS_pir_passes`
(an ordered comma list; default
"fold,cse,pattern,fuse,dce,shard_search,shard_prop,overlap": the three
sharding passes decline at once without a mesh scope, annotations or
collectives).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from .ir import Program, Ref, tensor_digest

__all__ = ["Pass", "PassResult", "PassManager", "DeadCodeElimination",
           "ConstantFolding", "CommonSubexprElimination", "PASSES",
           "PIPELINE_VERSION", "mutated_storage"]

# bump when pass semantics change in a way that invalidates cached
# artifacts of rewritten programs (2: the artifacts carry the sharding
# annotations and rule stamps)
PIPELINE_VERSION = 2

# The closed pass registry: every name FLAGS_pir_passes may list.
PASSES = {
    "fold": "constant folding (evaluates constant subgraphs once)",
    "cse": "common-subexpression elimination",
    "pattern": "DRR pattern rewriter (pt.sdpa, pt.sdpa_rms_epilogue)",
    "fuse": "cost-guided auto-fusion (pt.fused_region groups)",
    "dce": "dead code elimination",
    "shard_search": "cost-driven sharding search (argmin strategy)",
    "shard_prop": "GSPMD-style sharding propagation to fixpoint",
    "overlap": "collective-overlap scheduling (hide comm under compute)",
}

# results larger than this are not materialized by constant folding (a
# causal mask at 2048 x 2048 keys is 4 MiB of bool)
_FOLD_MAX_BYTES = 16 << 20

# input-free ops that fold: deterministic tensor factories (never
# empty*/rand*, whose contents are not a function of their arguments)
_FOLD_FACTORIES = ("ones", "zeros", "full", "arange", "eye",
                   "scalar_tensor", "linspace")


class PassResult:
    __slots__ = ("changed", "edits", "notes")

    def __init__(self, edits: int = 0, notes: str = ""):
        self.edits = int(edits)
        self.changed = self.edits > 0
        self.notes = notes

    def __repr__(self):
        return f"PassResult(edits={self.edits}, notes={self.notes!r})"


class Pass:
    name = "pass"

    def run(self, prog: Program) -> PassResult:  # pragma: no cover
        raise NotImplementedError


def _pinned(op) -> bool:
    """In-place, random or effect-scoped: never removed, folded, merged."""
    return op.has_effects() or op.attrs.get("effect") is not None


def mutated_storage(prog: Program):
    """A function op -> whether it reads or writes a buffer some in-place
    op of the program writes. Captured torch programs are not functional:
    an in-place op on a view changes its base, and the ops reading that
    base read it at their place in program order. Such ops are never
    folded (their value is not known before the program runs), merged
    (two reads of one Value at different times may differ) or moved into
    a fused or pattern region spliced elsewhere."""
    base: dict[int, int] = {}
    dirty: set[int] = set()

    def base_of(v):
        return base.get(id(v), id(v))

    for op in prog.ops:
        if op.target is None:
            continue
        args, kwargs = op.spec
        schema = op.target._schema
        written = []
        for i, a in enumerate(schema.arguments):
            ref = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                else args[i]
            if a.alias_info is not None and a.alias_info.is_write \
                    and isinstance(ref, Ref):
                written.append(op.inputs[ref.i])
        dirty.update(base_of(w) for w in written)
        src = written[0] if written else (
            op.inputs[args[0].i] if op.target.is_view and args
            and isinstance(args[0], Ref) else None)
        if src is not None:
            for o in op.outputs:
                base[id(o)] = base_of(src)

    def touches(op) -> bool:
        return any(base_of(v) in dirty for v in op.inputs) or \
            any(base_of(v) in dirty for v in op.outputs)

    return touches


class DeadCodeElimination(Pass):
    """Remove ops none of whose outputs reach a program output (and
    constants nothing reads); in-place, random and effect-scoped ops stay.
    A multi-result `pt.fused_region` whose promoted result lost its last
    reader keeps its live results only: the fused body is wrapped to return
    the kept indices, so the dead write disappears with its reader."""

    name = "dce"

    def run(self, prog: Program) -> PassResult:
        live = set(id(v) for v in prog.outputs)
        kept = []
        pruned_results = 0
        for op in reversed(prog.ops):
            if _pinned(op) or any(id(o) in live for o in op.outputs):
                if (op.name == "pt.fused_region" and op.fn is not None
                        and len(op.outputs) > 1
                        and any(id(o) not in live for o in op.outputs)):
                    keep = tuple(i for i, o in enumerate(op.outputs)
                                 if id(o) in live)
                    pruned_results += len(op.outputs) - len(keep)
                    op.outputs = [op.outputs[i] for i in keep]
                    inner = op.fn

                    def fn(*args, _inner=inner, _keep=keep):
                        res = _inner(*args)
                        return tuple(res[i] for i in _keep)

                    fn.__name__ = getattr(inner, "__name__", "fused_region")
                    body = getattr(inner, "body", None)
                    if body is not None:
                        fn.body = (body[0], body[1],
                                   [body[2][i] for i in keep], body[3])
                    op.fn = fn
                    fg = op.attrs.get("fusion_group")
                    if isinstance(fg, dict):
                        fg["outs"] = len(keep)
                        fg["keep"] = list(keep)
                    op._canon = None
                kept.append(op)
                live.update(id(v) for v in op.inputs)
        removed_ops = len(prog.ops) - len(kept)
        prog.ops = kept[::-1]
        live.update(id(v) for v in prog.inputs)
        dead_consts = [v for v in prog.constants if id(v) not in live]
        for v in dead_consts:
            del prog.constants[v]
        notes = f"ops={removed_ops} consts={len(dead_consts)}"
        if pruned_results:
            notes += f" fused_results={pruned_results}"
        return PassResult(removed_ops + len(dead_consts) + pruned_results,
                          notes)


def _foldable(op, lut, touches) -> bool:
    if op.target is None or _pinned(op) or touches(op) \
            or op.target.namespace == "_c10d_functional":
        return False                # a collective talks to other ranks
    if any(math.prod(o.shape) * o.dtype.itemsize > _FOLD_MAX_BYTES
           for o in op.outputs):
        return False
    if not op.inputs:
        return op.target.overloadpacket.__name__ in _FOLD_FACTORIES
    return all(id(v) in lut for v in op.inputs)


class ConstantFolding(Pass):
    """Evaluate ops whose operands are all constants (and deterministic
    input-free factories) once, and replace their results with constants.
    This is what turns mask and rope-table subgraphs into tensors the
    pattern matcher can reason about ("is this mask exactly tril?")."""

    name = "fold"

    def run(self, prog: Program) -> PassResult:
        lut = {id(v): c for v, c in prog.constants.items()}
        touches = mutated_storage(prog)
        folded = 0
        kept = []
        for op in prog.ops:
            if not _foldable(op, lut, touches):
                kept.append(op)
                continue
            try:
                with torch.no_grad():
                    outs = op.evaluate([lut[id(v)] for v in op.inputs])
            except Exception:  # noqa: BLE001 — a non-foldable op just stays
                kept.append(op)
                continue
            for v, o in zip(op.outputs, outs):
                prog.constants[v] = o
                v.op = None
                lut[id(v)] = o
            folded += 1
        prog.ops = kept
        return PassResult(folded, f"ops_folded={folded}")


class CommonSubexprElimination(Pass):
    """Merge ops with identical (name, operands, arguments); pt, in-place,
    random and effect-scoped ops are skipped. Duplicate constants merge by
    content."""

    name = "cse"

    def run(self, prog: Program) -> PassResult:
        replace: dict[int, object] = {}   # id(old Value) -> Value

        def res(v):
            return replace.get(id(v), v)

        merged = 0
        by_digest: dict[tuple, object] = {}
        for v, c in list(prog.constants.items()):
            key = (str(c.dtype), tuple(c.shape), str(c.device),
                   tensor_digest(c))
            first = by_digest.get(key)
            if first is None:
                by_digest[key] = v
            else:
                replace[id(v)] = first
                del prog.constants[v]
                merged += 1

        touches = mutated_storage(prog)
        seen: dict[tuple, object] = {}
        kept = []
        for op in prog.ops:
            op.inputs = [res(v) for v in op.inputs]
            if op.fn is not None or _pinned(op) or touches(op):
                kept.append(op)
                continue
            key = (op.name, tuple(id(v) for v in op.inputs), op.attr_text())
            prior = seen.get(key)
            if prior is None:
                seen[key] = op
                kept.append(op)
            else:
                for old, new in zip(op.outputs, prior.outputs):
                    replace[id(old)] = new
                merged += 1
        prog.ops = kept
        prog.outputs = [res(v) for v in prog.outputs]
        return PassResult(merged, f"merged={merged}")


def _registry():
    from .fuse import FusionPass
    from .overlap import CollectiveOverlap
    from .patterns import PatternRewriter
    from .shard_prop import ShardingPropagation
    from .shard_search import ShardingSearch
    reg = {
        "dce": DeadCodeElimination,
        "fold": ConstantFolding,
        "cse": CommonSubexprElimination,
        "pattern": PatternRewriter,
        "fuse": FusionPass,
        "shard_search": ShardingSearch,
        "shard_prop": ShardingPropagation,
        "overlap": CollectiveOverlap,
    }
    assert set(reg) == set(PASSES), "pass registry drifted from PASSES"
    return reg


class PassManager:
    """Ordered pass runner, instrumented through the observability catalog
    (pass wall time and edit counts) and spans."""

    def __init__(self, passes: Optional[list] = None):
        self.passes = list(passes) if passes is not None else []

    @classmethod
    def default(cls) -> "PassManager":
        """Pipeline from FLAGS_pir_passes (ordered comma list; an unknown
        name raises)."""
        from ..framework import flags as _flags
        spec = (_flags.flag_value("pir_passes") or "").strip()
        reg = _registry()
        passes = []
        for name in filter(None, (s.strip() for s in spec.split(","))):
            if name not in reg:
                raise ValueError(f"unknown PIR pass {name!r} in "
                                 f"FLAGS_pir_passes; registered: "
                                 f"{sorted(reg)}")
            passes.append(reg[name]())
        return cls(passes)

    def run(self, prog: Program) -> dict:
        """Run the passes in order; returns {pass name: {"seconds",
        "edits", "notes"}}. Under FLAGS_pir_verify "on" the verifier runs
        after every pass (strict dead-code right after dce); under
        "boundary" once after the last. An IRVerificationError propagates
        (pipeline.compile_flat counts it as stage "verify")."""
        from ..observability import span as _span
        from ..observability.catalog import metric as _metric
        from .verifier import verify_mode, verify_program
        mode = verify_mode()
        report: dict[str, dict] = {}
        with _span("pir.pipeline", program=prog.name, ops=len(prog.ops)):
            last_name = None
            for p in self.passes:
                t0 = time.perf_counter()
                with _span(f"pir.pass.{p.name}"):
                    result = p.run(prog)
                dt = time.perf_counter() - t0
                _metric("pir_pass_seconds", **{"pass": p.name}).observe(dt)
                if result.edits:
                    _metric("pir_pass_edits_total",
                            **{"pass": p.name}).inc(result.edits)
                report[p.name] = {"seconds": dt, "edits": result.edits,
                                  "notes": result.notes}
                last_name = p.name
                if mode == "on":
                    verify_program(prog, strict_dead=(p.name == "dce"),
                                   where=p.name)
            if mode == "boundary" and last_name is not None:
                verify_program(prog, strict_dead=(last_name == "dce"),
                               where=last_name)
        try:
            from ..observability.recorder import get_recorder
            rec = get_recorder()
            if rec.enabled:
                rec.record("pir_pipeline", program=prog.name,
                           passes=len(self.passes),
                           edits=sum(r["edits"] for r in report.values()))
        except Exception:  # noqa: BLE001 — black box never breaks a compile
            pass
        return report
