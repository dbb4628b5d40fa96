"""The compile pipeline: capture -> cache lookup -> verify -> passes ->
cost -> evaluator -> cache write.

reference: paddle_tpu/pir/pipeline.py, the layer jit.to_static calls
instead of raw `jax.jit`. Here the function is captured on fake tensors
into a pir.Program (pir/capture.py), verified, rewritten by the
instrumented pass pipeline (fold / CSE / DRR patterns / fusion / DCE /
the sharding search, propagation and collective overlap), priced by the
CostModel, and its evaluator is `Program.bind`: every op
replays as the torch call it was captured as (a `pt.*` op through its
callable), so the evaluator is differentiable by torch autograd. The
persistent compile cache is consulted right after capture, keyed on the
captured program's canonical hash and the flags that steer the passes
(pir/cache.py `cache_key`): a hit loads the verified artifact of the
rewritten program (pir/serialize.py) and skips verify and the passes; a
miss runs them and writes the artifact back (atomic, verified,
LRU-capped). The reference consults its cache last, to skip XLA's
compile; the port has no backend compile, so what a hit skips is the
verifier and the passes.

Sharding (reference :83-131, :235-250, :352-392): `input_shardings` (one
mesh-axis spec or None per flat leaf) are stamped on the captured inputs,
and `pir_jit(sharding_rules=...)` builds them from regex rules over the
argument tree's paths. A compile under `shard_prop.mesh_scope`, or with
specs, folds the specs and the mesh's axis sizes into the cache key, and
the evaluator of a program the propagation pass pinned a mesh on replays
under that mesh (shard_prop.py: a hint on one card, never a change of
numerics). The artifact carries every annotation and rule stamp
(pir/serialize.py), so a hit is annotated as the miss was.

Every failure degrades, never breaks: a pipeline error runs the function
as written (the port's counterpart of the reference's plain `jax.jit`),
counted in `pir_fallback_total{stage}` and recorded as `report.fallback`.
A graph break (pir.capture.GraphBreak) propagates untouched: that
contract belongs to to_static.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .cache import (CompileCacheCorruptionError, _bump, _metric, cache_key,
                    default_cache)
from .capture import GraphBreak, capture
from .fuse import FusionPassError
from .passes import PassManager
from .verifier import IRVerificationError, verify_mode, verify_program

__all__ = ["CompileReport", "compile_flat", "pir_jit"]


class CompileReport:
    """What the pipeline did for one program, with the seconds of each
    stage (capture, verify, passes, cost, evaluator, cache)."""

    __slots__ = ("name", "key", "cache", "pass_report", "program",
                 "captured_ops", "final_ops", "pattern_counts", "fallback",
                 "cost", "shard_decision", "shard_predicted_s",
                 "fusion_groups", "fusion_bytes_saved", "fusion_kinds",
                 "seconds")

    def __init__(self, name):
        self.name = name
        self.key = None
        self.cache = "off"          # off|miss|hit|error:<why>|miss:<why>
        self.pass_report = {}
        self.program = None         # the post-pass pir.Program
        self.captured_ops = 0
        self.final_ops = 0
        self.pattern_counts = {}
        self.fallback = None        # stage name when the pipeline fell back
        self.cost = None            # analysis.ProgramCost of the final IR
        self.shard_decision = None  # shard_search's argmin ("dp+tp", ...)
        self.shard_predicted_s = None
        self.fusion_groups = 0
        self.fusion_bytes_saved = 0   # none while regions replay
        self.fusion_kinds = {}
        self.seconds = {}

    def summary(self) -> dict:
        out = {"name": self.name, "cache": self.cache,
               "captured_ops": self.captured_ops,
               "final_ops": self.final_ops,
               "patterns": dict(self.pattern_counts),
               "passes": {k: {"edits": v["edits"],
                              "seconds": round(v["seconds"], 6)}
                          for k, v in self.pass_report.items()},
               "cost": self.cost.summary() if self.cost else None,
               "fusion_groups": self.fusion_groups,
               "fusion_bytes_saved": self.fusion_bytes_saved,
               "fusion_kinds": dict(self.fusion_kinds),
               "seconds": {k: round(v, 6) for k, v in self.seconds.items()},
               "fallback": self.fallback}
        if self.shard_decision is not None:
            out["shard_decision"] = self.shard_decision
            out["shard_predicted_s"] = self.shard_predicted_s
        return out


def _device_of(flat_args):
    for a in flat_args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            return a.device
    return None


def compile_flat(flat_fn: Callable, flat_args: list, *, name: str,
                 sharding: str = "replicated", donate_argnums=None,
                 vjp_order: int = 1, extra_key: Optional[dict] = None,
                 input_shardings: Optional[list] = None):
    """Compile `flat_fn(*flat_tensors) -> tuple of tensors` through the
    pipeline. Returns (callable, CompileReport). Raises only GraphBreak;
    pipeline-internal failures run `flat_fn` as written, with the fallback
    stage recorded. `input_shardings` optionally holds one spec (a tuple
    of mesh-axis names) or None per flat tensor, propagated by the
    sharding pass. `vjp_order` is accepted for the reference's signature:
    the replayed program is differentiated by torch autograd to any order
    its ops allow, cached or not."""
    from .shard_prop import annotate_inputs, current_mesh, \
        sharding_cache_tag
    report = CompileReport(name)
    if input_shardings or current_mesh() is not None:
        sharding = f"{sharding}|{sharding_cache_tag(input_shardings or [])}"
    t0 = time.perf_counter()
    try:
        prog, _ = capture(flat_fn, *flat_args, name=name)
        report.captured_ops = prog.num_ops()
    except GraphBreak:
        raise                       # graph-break contract: caller handles
    except Exception as e:  # noqa: BLE001 — degrade, never break a call
        return _fallback(flat_fn, report, "capture", e)
    report.seconds["capture"] = time.perf_counter() - t0
    if input_shardings:
        try:
            annotate_inputs(prog, input_shardings)
        except Exception as e:  # noqa: BLE001 — bad specs drop the hints,
            # not the compile: the program stays valid, unannotated
            for v in prog.inputs:
                v.sharding = None
            warnings.warn(f"input shardings for {name!r} dropped: {e!r}",
                          RuntimeWarning, stacklevel=2)

    # the cache is keyed on the captured program (the passes are
    # deterministic given it and the flags in the key), so a hit skips
    # verify and the passes
    cache = default_cache()
    if cache is not None and donate_argnums:
        report.cache = "bypass:donate"
        cache = None
    if cache is not None:
        t0 = time.perf_counter()
        loaded = None
        try:
            report.key = cache_key(prog.canonical_hash(), sharding=sharding,
                                   device=_device_of(flat_args),
                                   extra=extra_key)
            loaded = _cache_read(cache, report)
        except Exception as e:  # noqa: BLE001 — the cache may only cost time
            report.cache = f"error:{type(e).__name__}"
            cache = None
        report.seconds["cache_read"] = time.perf_counter() - t0
        if loaded is not None:
            prog, meta = loaded
            if current_mesh() is not None and _annotated(prog):
                prog._mesh = current_mesh()
            report.final_ops = prog.num_ops()
            report.pattern_counts = dict(meta.get("patterns") or {})
            fusion = meta.get("fusion") or {}
            report.fusion_groups = int(fusion.get("groups", 0))
            report.fusion_kinds = dict(fusion.get("kinds", {}))
            report.program = prog
            _price(report, prog)
            return _make_evaluator(prog), report

    t0 = time.perf_counter()
    try:
        if verify_mode() != "off":
            verify_program(prog, donate_argnums=donate_argnums,
                           where="capture")
    except Exception as e:  # noqa: BLE001 — a rejection or a bad flag
        return _fallback(flat_fn, report, "verify", e)
    report.seconds["verify"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    try:
        report.pass_report = PassManager.default().run(prog)
        report.final_ops = prog.num_ops()
        report.program = prog
        pat = report.pass_report.get("pattern", {})
        report.pattern_counts = {
            k: int(v) for k, v in (p.split("=") for p in
                                   (pat.get("notes") or "").split()
                                   if "=" in p)}
        decision = getattr(prog, "_shard_search", None)
        if decision is not None:
            report.shard_decision = decision["decision"]
            report.shard_predicted_s = decision["predicted_seconds"]
        fusion = getattr(prog, "_fusion", None)
        if fusion is not None:
            report.fusion_groups = fusion["groups"]
            report.fusion_bytes_saved = fusion["bytes_saved"]
            report.fusion_kinds = dict(fusion.get("kinds", {}))
    except FusionPassError as e:
        return _fallback(flat_fn, report, "fuse", e)
    except IRVerificationError as e:
        return _fallback(flat_fn, report, "verify", e)
    except Exception as e:  # noqa: BLE001
        return _fallback(flat_fn, report, "passes", e)
    report.seconds["passes"] = time.perf_counter() - t0

    _price(report, prog)

    t0 = time.perf_counter()
    try:
        evaluator = _make_evaluator(prog)
    except Exception as e:  # noqa: BLE001
        return _fallback(flat_fn, report, "evaluator", e)
    report.seconds["evaluator"] = time.perf_counter() - t0

    if cache is not None:
        t0 = time.perf_counter()
        try:
            if not report.cache.startswith("error:"):
                report.cache = "miss"
            _bump("miss")
            _metric("compile_cache_miss_total").inc()
            _flight("miss", report.name)
            if (getattr(prog, "_fusion", None) or {}).get("skipped"):
                # a group skipped by a fault: the artifact would keep the
                # degraded program under the clean program's key
                report.cache = "miss:degraded"
            else:
                _cache_write(cache, report, prog)
        except Exception as e:  # noqa: BLE001 — the cache may only cost time
            report.cache = f"error:{type(e).__name__}"
        report.seconds["cache_write"] = time.perf_counter() - t0
    return evaluator, report


def _price(report, prog):
    t0 = time.perf_counter()
    try:
        from .analysis import CostModel
        report.cost = CostModel().analyze(prog)
    except Exception:  # noqa: BLE001 — pricing may never cost a compile
        report.cost = None
    report.seconds["cost"] = time.perf_counter() - t0


def _flight(status, name):
    """Flight-recorder compile-cache event (hit/miss/corrupt/store)."""
    try:
        from ..observability.recorder import get_recorder
        rec = get_recorder()
        if rec.enabled:
            rec.record("compile_cache", status=status, program=name)
    except Exception:  # noqa: BLE001
        pass


def _annotated(prog) -> bool:
    return any(v.sharding is not None for v in prog.inputs) or any(
        o.sharding is not None for op in prog.ops for o in op.outputs)


def _make_evaluator(prog):
    mesh = prog._mesh
    if mesh is None:
        def evaluate(*flat):
            return prog.bind(*flat)
    else:
        # the propagation pass pinned the scope's mesh on the program: the
        # replay hints its results under it wherever the caller dispatches
        from .shard_prop import mesh_scope

        def evaluate(*flat):
            with mesh_scope(mesh):
                return prog.bind(*flat)
    evaluate.__name__ = f"pir_eval_{prog.name}"
    evaluate.program = prog
    return evaluate


def _fallback(flat_fn, report, stage, err):
    report.fallback = stage
    _metric("pir_fallback_total", stage=stage).inc()
    warnings.warn(
        f"pir pipeline fell back to running {report.name!r} as written at "
        f"stage {stage!r}: {err!r}", RuntimeWarning, stacklevel=3)
    return flat_fn, report


def _corrupt(cache, report, why):
    _bump("corrupt")
    _metric("compile_cache_corrupt_total").inc()
    _flight("corrupt", report.name)
    warnings.warn(f"{why}; recompiling", RuntimeWarning, stacklevel=4)
    cache.drop(report.key)


def _cache_read(cache, report):
    """(the artifact's program, its meta), or None. Corruption is a typed, counted
    error that degrades to the fresh compile (the artifact is dropped)."""
    from .serialize import loads
    try:
        hit = cache.get(report.key)
    except CompileCacheCorruptionError as e:
        _corrupt(cache, report, str(e))
        return None
    except Exception as e:  # noqa: BLE001 — IO trouble or ANY injected
        # class: a cache read may only ever cost a recompile
        _bump("read_error")
        report.cache = f"error:read:{type(e).__name__}"
        return None
    if hit is None:
        return None
    payload, meta = hit
    try:
        prog = loads(payload, report.name)
    except Exception as e:  # noqa: BLE001 — unloadable == corrupt
        _corrupt(cache, report, f"compile-cache artifact "
                 f"{report.key[:12]} verified but did not load ({e!r})")
        return None
    report.cache = "hit"
    _bump("hit")
    _metric("compile_cache_hit_total").inc()
    _flight("hit", report.name)
    return prog, meta


def _cache_write(cache, report, prog):
    from .serialize import dumps
    try:
        payload = dumps(prog)
    except Exception as e:  # noqa: BLE001 — unserializable: no artifact
        report.cache = f"miss:unserializable:{type(e).__name__}"
        return
    try:
        cache.put(report.key, payload,
                  meta={"name": report.name,
                        "captured_ops": report.captured_ops,
                        "final_ops": report.final_ops,
                        "patterns": report.pattern_counts,
                        "fusion": {"groups": report.fusion_groups,
                                   "kinds": report.fusion_kinds}})
    except Exception as e:  # noqa: BLE001 — write failures degrade, counted
        _bump("write_error")
        report.cache = f"error:write:{type(e).__name__}"
        warnings.warn(f"compile-cache write failed for {report.name!r} "
                      f"({e!r}); continuing uncached", RuntimeWarning,
                      stacklevel=4)
        return
    _bump("write")
    _metric("compile_cache_write_total").inc()
    _flight("store", report.name)


class pir_jit:
    """A lazily compiled function over pytree arguments: the first call's
    arguments fix the signature (tree structure, shapes, and the value of
    every leaf that is not a tensor: None, an int, ... which, as in a jax
    pytree, is structure and not a program input) and the pipeline
    compiles (or warm-loads) the program; later calls must match it.
    Sharding annotations for the propagation pass come as a flat per-leaf
    spec list (`input_shardings`) or as [(regex, spec)] rules matched on
    the argument tree's paths at the first call (`sharding_rules`; the
    rules win if both are given)."""

    def __init__(self, fn, *, name=None, sharding="replicated",
                 donate_argnums=None, vjp_order=0, extra_key=None,
                 input_shardings=None, sharding_rules=None):
        self._fn = fn
        self._input_shardings = input_shardings
        self._sharding_rules = sharding_rules
        self.name = name or getattr(fn, "__name__", "pir_jit")
        self._sharding = sharding
        self._donate = donate_argnums
        self._extra = extra_key
        self._compiled = None
        self._box = {}
        self._pos = None        # flat positions of the tensor leaves
        self.report: Optional[CompileReport] = None

    def _build(self, args):
        from ..framework import flags as _flags
        flat, in_spec = pytree.tree_flatten(args)
        pos = self._pos = [i for i, a in enumerate(flat)
                           if isinstance(a, torch.Tensor)]
        box = self._box = {}

        def flat_fn(*leaves):
            full = list(flat)
            for i, t in zip(pos, leaves):
                full[i] = t
            out = self._fn(*pytree.tree_unflatten(full, in_spec))
            out_flat, box["spec"] = pytree.tree_flatten(out)
            return tuple(out_flat)

        if not _flags.flag_value("pir"):
            self.report = CompileReport(self.name)
            self.report.cache = "disabled"
            self._compiled = flat_fn
            return
        index = {p: k for k, p in enumerate(pos)}
        donate_flat = None
        if self._donate:
            donate_flat, off = [], 0
            for i, a in enumerate(args):
                n = len(pytree.tree_leaves(a))
                if i in self._donate:
                    donate_flat.extend(index[j] for j in range(off, off + n)
                                       if j in index)
                off += n
        specs = self._input_shardings
        if self._sharding_rules is not None:
            try:
                from .shard_prop import flat_input_specs
                specs = flat_input_specs(args, self._sharding_rules)
            except Exception as e:  # noqa: BLE001 — hints degrade
                warnings.warn(f"sharding rules for {self.name!r} dropped: "
                              f"{e!r}", RuntimeWarning, stacklevel=3)
                specs = None
        if specs is not None and len(specs) == len(flat):
            specs = [specs[i] for i in pos]
        self._compiled, self.report = compile_flat(
            flat_fn, [flat[i] for i in pos], name=self.name,
            sharding=self._sharding, donate_argnums=donate_flat,
            extra_key=self._extra, input_shardings=specs)

    def __call__(self, *args):
        if self._compiled is None:
            self._build(args)
        flat = pytree.tree_leaves(args)
        out = self._compiled(*[flat[i] for i in self._pos])
        return pytree.tree_unflatten(list(out), self._box["spec"])
