"""The port's structural verifier and dataflow analyses
(paddle_tpu_torch/pir/verifier.py, mutate.py, analysis.py) on the CPU.

The mutation matrix is the contract, as in the reference's
tests/test_pir_verifier.py: every seeded corruption in pir.CORRUPTIONS
must be rejected with exactly the rule it names, and every legitimate
captured program must verify clean through the whole pass pipeline. The
rule and corruption registries are the reference's, name for name.
"""

import pytest
import torch

from paddle_tpu import pir as ref_pir
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import pir
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.pir.analysis import (CONFLICT, FlatLattice, Liveness,
                                           ShapeDtypeInference,
                                           ShardingConsistency,
                                           check_donation_safety)
from paddle_tpu_torch.resilience import faults
from torch_one_thread import one_torch_thread  # noqa: F401


def _plain_fn(x, y):
    h = torch.tanh(x @ y)
    return (h * 2.0 + x[:, :4], h.sum())


def _plain_args():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(4, 8, generator=g), torch.randn(8, 4, generator=g)]


def _kv_fn(x, pool):
    """Two effect-scoped writes and a rollback, as a hand-written or
    unrolled program would hold them."""
    a, b, z = x * 2.0, x + 1.0, x * 0.0
    with pir.effect_scope("kv.write"):
        pool[0:4].copy_(a)
    with pir.effect_scope("kv.write"):
        pool[4:8].copy_(b)
    with pir.effect_scope("kv.rollback"):
        pool[0:4].copy_(z)
    return (pool * 1.0, pool.sum().to(torch.int32))


def _kv_args():
    return [torch.randn(4, 4, generator=torch.Generator().manual_seed(1)),
            torch.zeros(8, 4)]


def _capture_kv():
    return pir.capture(_kv_fn, *_kv_args(), name="kv_fixture")[0]


def _capture_plain():
    return pir.capture(_plain_fn, *_plain_args(), name="plain")[0]


def test_registries_are_the_references():
    assert set(pir.RULES) == set(ref_pir.RULES)
    assert pir.EFFECT_SCOPES == ref_pir.EFFECT_SCOPES
    assert {k: r for k, (_, r) in pir.CORRUPTIONS.items()} == \
        {k: r for k, (_, r) in ref_pir.CORRUPTIONS.items()}


def test_clean_program_verifies_after_every_pass():
    prog = _capture_plain()
    pir.verify_program(prog, where="capture")
    for p in pir.PassManager.default().passes:
        p.run(prog)
        pir.verify_program(prog, strict_dead=(p.name == "dce"), where=p.name)


def test_kv_program_verifies_and_replays():
    prog = _capture_kv()
    eff = [op.attrs["effect"] for op in prog.ops if op.attrs.get("effect")]
    assert eff == ["kv.write", "kv.write", "kv.rollback"]
    pir.verify_program(prog)
    got = prog.bind(*_kv_args())
    want = _kv_fn(*_kv_args())
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.parametrize("kind", sorted(pir.CORRUPTIONS))
def test_mutation_matrix(kind):
    _mutator, rule = pir.CORRUPTIONS[kind]
    prog = _capture_kv() if kind == "reorder-kv-write" else _capture_plain()
    pir.verify_program(prog)                    # clean before
    what = pir.corrupt(prog, kind, seed=0)
    with pytest.raises(pir.IRVerificationError) as e:
        pir.verify_program(prog, where="mutated")
    assert e.value.rule == rule, f"{kind} ({what}) caught as {e.value.rule}"


def test_error_carries_rule_op_and_excerpt():
    prog = _capture_plain()
    pir.corrupt(prog, "forge-dtype", seed=0)
    with pytest.raises(pir.IRVerificationError) as e:
        pir.verify_program(prog)
    assert e.value.rule == "type-mismatch" and e.value.op_name
    assert "program @plain" in e.value.excerpt and "[type-mismatch]" in \
        str(e.value)
    with pytest.raises(KeyError):
        pir.corrupt(_capture_plain(), "no-such-corruption")


def test_donation_safety():
    def read_then_write(pool, x):
        y = pool * 2.0
        return (y + pool.add_(x),)

    def single(pool, x):
        return (pool.add_(x),)

    def elementwise(pool, x):
        return (pool * 2.0 + pool,)

    args = [torch.zeros(4, 4), torch.ones(4, 4)]
    prog = pir.capture(read_then_write, *args)[0]
    assert check_donation_safety(prog, [0]) == []     # read, then write
    # a pass that moved the read past the in-place write: the donated
    # buffer is read again after it was overwritten
    read = next(op for op in prog.ops if op.name == "aten.mul.Tensor")
    prog.ops.remove(read)
    at = next(i for i, op in enumerate(prog.ops) if op.name.startswith(
        "aten.add_"))
    prog.ops.insert(at + 1, read)
    assert check_donation_safety(prog, [0])
    with pytest.raises(pir.IRVerificationError) as e:
        pir.verify_program(prog, donate_argnums=[0])
    assert e.value.rule == "donation-alias"
    for fn in (single, elementwise):
        assert check_donation_safety(pir.capture(fn, *args)[0], [0]) == []


def test_shape_inference_rederives_every_value():
    prog = _capture_plain()
    facts = ShapeDtypeInference().run(prog)
    for op in prog.ops:
        for o in op.outputs:
            assert facts[id(o)] == (o.shape, str(o.dtype).split(".")[-1])


def test_liveness_last_use_and_exit_set():
    prog = _capture_plain()
    lv = Liveness()
    facts = lv.run(prog)
    assert facts["exit"] == frozenset(id(v) for v in prog.outputs)
    x = prog.inputs[0]
    assert lv.last_use[id(x)] == max(lv.uses[id(x)])
    n = len(prog.ops)
    assert facts[("after", n - 1)] >= facts["exit"]


def test_flat_lattice_and_sharding_consistency():
    lat = FlatLattice()
    assert lat.join(None, "a") == "a" and lat.join("a", "a") == "a"
    assert lat.join("a", "b") is CONFLICT
    prog = _capture_plain()
    op = next(o for o in prog.ops if len(o.inputs) == 2)
    op.inputs[0].sharding = ("dp", None)
    sc = ShardingConsistency()
    sc.run(prog)
    assert sc.conflicts == []          # pending constraint, not an error
    op.inputs[1].sharding = ("mp", None)
    op.outputs[0].sharding = ("dp", None)
    sc = ShardingConsistency()
    sc.run(prog)
    assert sc.conflicts and sc.conflicts[0][0] is op


def test_verify_mode_validates_flag():
    prev = _flags.flag_value("pir_verify")
    try:
        for mode in ("off", "boundary", "on"):
            _flags.set_flags({"pir_verify": mode})
            assert pir.verify_mode() == mode
        _flags.set_flags({"pir_verify": "sometimes"})
        with pytest.raises(ValueError):
            pir.verify_mode()
    finally:
        _flags.set_flags({"pir_verify": prev})


def test_injected_verify_fault_degrades_and_counts():
    obs.get_registry().reset()
    obs.enable()
    try:
        with faults.injected_faults("compile.verify:1:RuntimeError"):
            with pytest.warns(RuntimeWarning, match="verify"):
                fn, rep = pir.compile_flat(_plain_fn, _plain_args(),
                                           name="vf")
        assert rep.fallback == "verify" and fn is _plain_fn
        fam = obs.get_registry().get("pir_verify_failures_total")
        assert fam.labels(rule="verifier-error").value == 1
        assert obs.get_registry().get("pir_fallback_total").labels(
            stage="verify").value == 1
    finally:
        obs.disable()
        obs.get_registry().reset()
