"""Seeded IR corruptions for mutation-testing the verifier.

reference: paddle_tpu/pir/mutate.py. Each corruption models one real pass-bug family (operand rewiring gone
wrong, a dropped definition, a forged type stamp, reordered stateful
ops, ...) and names the verifier rule that MUST reject it; the tests
apply the whole matrix to captured programs and assert that every one is
caught with exactly that rule. A
verifier change that silently stops catching a family fails the matrix,
the same way the chaos drill fails on an escaped fault.

All corruptions mutate the program in place and are seeded
(``random.Random(seed)``) so a failure reproduces exactly. ``corrupt``
raises ``SkipCorruption`` when the program has no viable target (e.g.
no two differently-typed operands to swap). The two sharding
corruptions work on hand-set annotations, as a pass's stamps would be.
"""

from __future__ import annotations

import random

from .ir import Program

__all__ = ["CORRUPTIONS", "SkipCorruption", "corrupt"]


class SkipCorruption(Exception):
    """The program offers no target for this corruption."""


def _rng(seed):
    return random.Random(f"pir-mutate:{seed}")


def _swap_operands(prog: Program, rng) -> str:
    """A rewrite wired an op's operands in the wrong order. Pick a captured
    op with two operands of different type so the swap is a *type* error
    (same-typed swaps are value bugs no structural rule can see)."""
    cands = []
    for op in prog.ops:
        if op.target is None:
            continue
        for i in range(len(op.inputs)):
            for j in range(i + 1, len(op.inputs)):
                a, b = op.inputs[i], op.inputs[j]
                if (a.shape, str(a.dtype)) != (b.shape, str(b.dtype)):
                    cands.append((op, i, j))
    if not cands:
        raise SkipCorruption("no op with differently-typed operands")
    op, i, j = rng.choice(cands)
    op.inputs[i], op.inputs[j] = op.inputs[j], op.inputs[i]
    return f"swapped operands {i}<->{j} of {op.name!r}"


def _drop_def(prog: Program, rng) -> str:
    """A pass deleted an op whose results are still consumed."""
    users = prog.users()
    cands = [op for op in prog.ops
             if any(u is not None
                    for o in op.outputs for u in users.get(o, ()))]
    if not cands:
        raise SkipCorruption("no op with op-consumed results")
    op = rng.choice(cands)
    prog.ops.remove(op)
    return f"dropped defining op {op.name!r}"


def _forge_dtype(prog: Program, rng) -> str:
    """A rewrite stamped the wrong dtype on a result Value."""
    import torch
    cands = [o for op in prog.ops if op.target is not None
             for o in op.outputs]
    if not cands:
        raise SkipCorruption("no captured-op results")
    v = rng.choice(cands)
    forged = torch.int16 if v.dtype != torch.int16 else torch.float64
    v.dtype = forged
    return f"forged dtype of %{v.vid} to {forged}"


def _double_def(prog: Program, rng) -> str:
    """A buggy merge made a second op claim an existing Value."""
    if len(prog.ops) < 2:
        raise SkipCorruption("fewer than two ops")
    i = rng.randrange(len(prog.ops) - 1)
    j = rng.randrange(i + 1, len(prog.ops))
    val_a = prog.ops[i].outputs[0]
    prog.ops[j].outputs[0] = val_a
    return f"{prog.ops[j].name!r} re-defines %{val_a.vid}"


def _bad_arity(prog: Program, rng) -> str:
    """An operand list lost an entry during rewiring."""
    cands = [op for op in prog.ops
             if op.target is not None and len(op.inputs) >= 1]
    if not cands:
        raise SkipCorruption("no captured op with operands")
    op = rng.choice(cands)
    op.inputs.pop()
    return f"dropped the last operand of {op.name!r}"


def _dangling_output(prog: Program, rng) -> str:
    """A program output points at a Value nothing defines."""
    if not prog.outputs:
        raise SkipCorruption("no program outputs")
    i = rng.randrange(len(prog.outputs))
    old = prog.outputs[i]
    prog.outputs[i] = prog.new_value(old.shape, old.dtype)
    return f"output {i} replaced with an undefined value"


def _reorder_kv_write(prog: Program, rng) -> str:
    """A pass reordered stateful paged-KV ops: swap the captured
    effect_seq stamps of two effect ops (equivalently, the ops moved
    past each other in program order)."""
    eff = [op for op in prog.ops if op.attrs.get("effect") is not None]
    if len(eff) < 2:
        raise SkipCorruption("fewer than two effect-stamped ops")
    a, b = rng.sample(eff, 2)
    a.attrs["effect_seq"], b.attrs["effect_seq"] = \
        b.attrs["effect_seq"], a.attrs["effect_seq"]
    return (f"swapped effect_seq of {a.name!r} and {b.name!r} "
            f"({a.attrs['effect']}/{b.attrs['effect']})")


def _sharding_clash(prog: Program, rng) -> str:
    """A propagation bug committed output shardings across an op whose
    operands irreconcilably disagree — without declaring the
    ``sharding_rule`` contract that would make the divergence legal.
    (Annotating only the operands is NOT a corruption: that is the
    legitimate pending state between annotate_inputs and the
    shard_prop pass.)"""
    cands = [op for op in prog.ops
             if len(op.inputs) >= 2 and op.outputs
             and op.inputs[0] is not op.inputs[1]]
    if not cands:
        raise SkipCorruption("no op with two distinct operands")
    op = rng.choice(cands)
    op.inputs[0].sharding = ("data", None)
    op.inputs[1].sharding = ("model", None)
    for o in op.outputs:
        o.sharding = ("data",) + (None,) * max(0, len(o.shape) - 1)
    return (f"committed output shardings of {op.name!r} over clashing "
            f"operand annotations")


def _sharding_rule_forge(prog: Program, rng) -> str:
    """A half-applied propagation stamp: an op claims a
    ``sharding_rule`` boundary (operands may legally diverge there) but
    its outputs never received the annotations the contract requires —
    the forged stamp must not silence the consistency check."""
    cands = [op for op in prog.ops
             if op.outputs and not op.attrs.get("sharding_rule")]
    if not cands:
        raise SkipCorruption("no op to stamp")
    op = rng.choice(cands)
    op.attrs["sharding_rule"] = "forged(data,model)"
    for o in op.outputs:
        o.sharding = None
    # make the check reachable: some annotation must exist in the
    # program for the verifier to engage the sharding analysis at all
    if op.inputs:
        op.inputs[0].sharding = \
            ("data",) + (None,) * max(0, len(op.inputs[0].shape) - 1)
    elif prog.inputs:
        prog.inputs[0].sharding = \
            ("data",) + (None,) * max(0, len(prog.inputs[0].shape) - 1)
    return f"stamped forged sharding_rule on {op.name!r} with bare outputs"


# corruption name -> (mutator, verifier rule that must reject it)
CORRUPTIONS = {
    "swap-operands": (_swap_operands, "type-mismatch"),
    "drop-def": (_drop_def, "def-before-use"),
    "forge-dtype": (_forge_dtype, "type-mismatch"),
    "double-def": (_double_def, "single-def"),
    "bad-arity": (_bad_arity, "arity"),
    "dangling-output": (_dangling_output, "dangling-value"),
    "reorder-kv-write": (_reorder_kv_write, "effect-order"),
    "sharding-clash": (_sharding_clash, "sharding-conflict"),
    "sharding-rule-forge": (_sharding_rule_forge, "sharding-conflict"),
}


def corrupt(prog: Program, kind: str, seed: int = 0) -> str:
    """Apply one seeded corruption in place; returns a description.
    Unknown kinds raise KeyError (closed registry)."""
    mutator, _expected_rule = CORRUPTIONS[kind]
    return mutator(prog, _rng(seed))
