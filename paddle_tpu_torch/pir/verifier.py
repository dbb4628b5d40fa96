"""Structural verifier for pir.Program.

reference: paddle_tpu/pir/verifier.py (after paddle/pir's pir::Verify): the
wall between "a pass has a bug" and "the bug ships in a compiled program".
Every check is a named rule from a CLOSED registry; a failure raises the
typed `IRVerificationError` naming the op, the rule, and an excerpt of the
printed IR around it.

Runs under `FLAGS_pir_verify`:

* "on": after capture and after every enabled pass;
* "boundary" (default): after capture and after the final pass;
* "off": never.

A verify failure in the compile pipeline runs the function as written,
counted in `pir_fallback_total{stage="verify"}`: the verifier may reject a
program, never break a call. Wall time lands in `pir_verify_seconds`, each
rejection in `pir_verify_failures_total{rule}`.
`fault_point("compile.verify")` is the chaos seam: an injected fault there
degrades the same way (wrapped as `verifier-error`).
"""

from __future__ import annotations

import time
from typing import Optional

from .analysis import (ShapeDtypeInference, ShardingConsistency,
                       check_donation_safety)
from .ir import Operation, Program, dtype_name

__all__ = ["RULES", "EFFECT_SCOPES", "IRVerificationError",
           "verify_program", "verify_mode"]

# The closed rule registry; pir/mutate.py's corruptions name these.
RULES = {
    "def-before-use": "every operand is defined (input/constant/earlier "
                      "op output) before the op that consumes it",
    "single-def": "every Value is defined exactly once (SSA)",
    "arity": "operand/result counts match the captured op's",
    "dangling-value": "program outputs (and operand back-references) "
                      "resolve to a definition inside the program",
    "dead-code": "post-DCE only: no side-effect-free op whose results "
                 "never reach a program output survives; fused regions "
                 "are held per-result (no dead promoted group output)",
    "effect-order": "stateful paged-KV ops (kv.write / kv.rollback "
                    "scopes) keep their captured program order",
    "type-mismatch": "stamped Value shape/dtype agrees with the "
                     "re-derived fake-tensor evaluation, and a captured "
                     "op's operands keep their captured types",
    "donation-alias": "a donated input is dead once an in-place op "
                      "overwrites its buffer (no donated double-buffer)",
    "sharding-conflict": "sharding annotations propagate without "
                         "contradiction (analysis.ShardingConsistency)",
    "verifier-error": "the verifier itself failed (internal bug or an "
                      "injected compile.verify fault); wrapped, counted, "
                      "degrades like any rejection",
}

# effect-scope names that mark an op as a stateful paged-KV effect;
# capture stamps matching ops with attrs["effect"] / attrs["effect_seq"]
# (pir/capture.py) and the effect-order rule holds them to captured
# program order through every pass.
EFFECT_SCOPES = ("kv.write", "kv.rollback")


class IRVerificationError(Exception):
    """A program failed verification: carries the rule name, the offending
    op (when attributable), and an IR excerpt for the log."""

    def __init__(self, rule: str, message: str,
                 op: Optional[Operation] = None,
                 program: Optional[Program] = None):
        assert rule in RULES, f"unregistered verifier rule {rule!r}"
        self.rule = rule
        self.op_name = op.name if op is not None else None
        self.excerpt = _excerpt(program, op) if program is not None else ""
        text = f"[{rule}] {message}"
        if self.op_name:
            text += f" (op {self.op_name!r})"
        if self.excerpt:
            text += "\n" + self.excerpt
        super().__init__(text)


def _excerpt(prog: Program, op: Optional[Operation], context: int = 3) -> str:
    """A window of the printed IR around the failing op."""
    try:
        lines = prog.to_string(include_attrs=False).splitlines()
        if op is None:
            return "\n".join(lines[:2 * context + 4])
        probe = f'"{op.name}"'
        head = ", ".join(repr(o) for o in op.outputs)
        at = next((i for i, ln in enumerate(lines)
                   if probe in ln and head and ln.strip().startswith(head)),
                  None)
        if at is None:
            at = next((i for i, ln in enumerate(lines) if probe in ln), 0)
        lo, hi = max(1, at - context), min(len(lines) - 1, at + context + 1)
        body = ["  ..."] if lo > 1 else []
        body += lines[lo:hi]
        if hi < len(lines) - 1:
            body.append("  ...")
        return "\n".join([lines[0]] + body + [lines[-1]])
    except Exception:  # noqa: BLE001 — excerpting never masks the failure
        return ""


def verify_mode() -> str:
    """FLAGS_pir_verify, validated: off | boundary | on."""
    from ..framework import flags as _flags
    mode = str(_flags.flag_value("pir_verify")).strip().lower()
    if mode not in ("off", "boundary", "on"):
        raise ValueError(f"FLAGS_pir_verify={mode!r}; "
                         "expected off | boundary | on")
    return mode


def verify_program(prog: Program, *, strict_dead: bool = False,
                   donate_argnums=None, where: str = "capture") -> None:
    """Run every structural rule; raises IRVerificationError on the first
    violation. `strict_dead` enables the dead-code rule (meaningful right
    after a DCE run); `donate_argnums` (flat input indices) enables the
    donation-alias rule; `where` labels the verify point."""
    t0 = time.perf_counter()
    try:
        from ..resilience.faults import fault_point
        fault_point("compile.verify", program=prog.name, where=where)
        _verify(prog, strict_dead=strict_dead, donate_argnums=donate_argnums)
    except IRVerificationError as e:
        _count_failure(e.rule)
        raise
    except Exception as e:  # noqa: BLE001 — internal bug or injected fault:
        # wrapped to the typed error so the pipeline degrades
        _count_failure("verifier-error")
        raise IRVerificationError(
            "verifier-error",
            f"verify({where}) of {prog.name!r} failed internally: "
            f"{type(e).__name__}: {e}") from e
    finally:
        try:
            from ..observability.catalog import metric
            metric("pir_verify_seconds").observe(time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 — timing never breaks a verify
            pass


def _count_failure(rule: str) -> None:
    try:
        from ..observability.catalog import metric
        metric("pir_verify_failures_total", rule=rule).inc()
    except Exception:  # noqa: BLE001
        pass


def _is_effect(op) -> bool:
    return op.has_effects() or op.attrs.get("effect") is not None


def _type_of(v):
    return (tuple(v.shape), dtype_name(v.dtype))


def _verify(prog, *, strict_dead, donate_argnums):
    defined: dict[int, str] = {}
    for v in prog.inputs:
        defined[id(v)] = "input"
    for v in prog.constants:
        defined[id(v)] = "const"
    op_ids = {id(op) for op in prog.ops}

    effect_prev = None        # (seq, op) of the last effect op seen
    for op in prog.ops:
        for v in op.inputs:
            if id(v) not in defined:
                raise IRVerificationError(
                    "def-before-use",
                    f"operand %{v.vid} of {op.name!r} is used before any "
                    f"definition (no input, constant, or earlier op "
                    f"defines it)", op=op, program=prog)
        for o in op.outputs:
            if id(o) in defined:
                raise IRVerificationError(
                    "single-def",
                    f"%{o.vid} is defined again by {op.name!r} (already "
                    f"defined as {defined[id(o)]})", op=op, program=prog)
            defined[id(o)] = f"op:{op.name}"
        for v in op.inputs:
            if v.op is not None and defined.get(id(v), "").startswith("op:") \
                    and id(v.op) not in op_ids:
                raise IRVerificationError(
                    "dangling-value",
                    f"operand %{v.vid} of {op.name!r} back-references a "
                    f"defining op not present in the program",
                    op=op, program=prog)
        if op.target is not None:
            if len(op.inputs) != len(op.in_types) \
                    or len(op.outputs) != op.n_out:
                raise IRVerificationError(
                    "arity",
                    f"{op.name!r} carries {len(op.inputs)} operands / "
                    f"{len(op.outputs)} results but was captured with "
                    f"{len(op.in_types)} / {op.n_out}", op=op, program=prog)
        elif not op.outputs:
            raise IRVerificationError(
                "arity", f"pt op {op.name!r} produces no results",
                op=op, program=prog)
        eff = op.attrs.get("effect")
        if eff is not None:
            seq = op.attrs.get("effect_seq")
            if effect_prev is not None and (seq is None
                                            or seq <= effect_prev[0]):
                raise IRVerificationError(
                    "effect-order",
                    f"stateful op {op.name!r} ({eff}, seq={seq}) appears "
                    f"after {effect_prev[1].name!r} "
                    f"(seq={effect_prev[0]}): paged-KV effects must keep "
                    f"captured program order", op=op, program=prog)
            effect_prev = (seq, op)

    for v in prog.outputs:
        if id(v) not in defined:
            raise IRVerificationError(
                "dangling-value",
                f"program output %{v.vid} has no definition in the "
                f"program", program=prog)

    inf = ShapeDtypeInference()
    facts = inf.run(prog)
    for op in prog.ops:
        expected_in = inf.derived_in_types(op)
        if expected_in is not None:
            for v, exp in zip(op.inputs, expected_in):
                if _type_of(v) != (tuple(exp[0]), exp[1]):
                    raise IRVerificationError(
                        "type-mismatch",
                        f"operand %{v.vid} of {op.name!r} is stamped "
                        f"{v.type_str} but the op was captured with "
                        f"{exp[1]}[{','.join(map(str, exp[0]))}]",
                        op=op, program=prog)
        for o in op.outputs:
            derived = facts.get(id(o))
            if derived is not None and _type_of(o) != derived:
                raise IRVerificationError(
                    "type-mismatch",
                    f"result %{o.vid} of {op.name!r} is stamped "
                    f"{o.type_str} but abstract eval derives "
                    f"{derived[1]}[{','.join(map(str, derived[0]))}]",
                    op=op, program=prog)

    if strict_dead:
        live = set(id(v) for v in prog.outputs)
        for op in reversed(prog.ops):
            if _is_effect(op) or any(id(o) in live for o in op.outputs):
                live.update(id(v) for v in op.inputs)
        for op in prog.ops:
            if not _is_effect(op) \
                    and not any(id(o) in live for o in op.outputs):
                raise IRVerificationError(
                    "dead-code",
                    f"{op.name!r} survives DCE but none of its results "
                    f"reach a program output", op=op, program=prog)
            # a fused region carrying a dead promoted result means DCE
            # failed to shrink its signature
            if op.name == "pt.fused_region" and not _is_effect(op):
                for o in op.outputs:
                    if id(o) not in live:
                        raise IRVerificationError(
                            "dead-code",
                            f"fused region result %{o.vid} survives DCE "
                            f"but never reaches a program output "
                            f"(dead promoted group output)",
                            op=op, program=prog)

    if donate_argnums:
        hazards = check_donation_safety(prog, donate_argnums)
        if hazards:
            h = hazards[0]
            raise IRVerificationError(
                "donation-alias",
                f"donated input %{h.value.vid} is read again (op "
                f"{h.use_index}) after {h.overwrite_op.name!r} (op "
                f"{h.overwrite_index}) overwrites its buffer in place — "
                f"donated double-buffer hazard",
                op=h.overwrite_op, program=prog)

    if any(getattr(v, "sharding", None) is not None
           for op in prog.ops for v in list(op.inputs) + list(op.outputs)) \
            or any(getattr(v, "sharding", None) is not None
                   for v in prog.inputs):
        sc = ShardingConsistency()
        sc.run(prog)
        if sc.conflicts:
            op, detail = sc.conflicts[0]
            raise IRVerificationError(
                "sharding-conflict", detail, op=op, program=prog)
