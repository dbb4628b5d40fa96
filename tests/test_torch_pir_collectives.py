"""The port's collective tags, the CostModel's communication terms and the
collective-overlap pass, on the CPU.

A captured port program's collectives are `_c10d_functional` ops. The
reference cannot see a collective inside a shard_map under this JAX (its
psum is `psum_invariant`, not in its registry), so its overlap test fails
on the reference itself; here the port's exposed-communication term is
held to the reference's formula on the same per-op comm and compute
(`CostModel.exposed_comm_seconds` of paddle_tpu.pir.analysis, with its
`comm_seconds` monkeypatched inside the test), and the overlap cases of
tests/test_pir_sharding.py:182-242 are rewritten in torch over a one-rank
gloo group: a pure reorder, so the replay equals eager bit for bit.
"""

import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from paddle_tpu.pir import analysis as janalysis
from paddle_tpu_torch import pir
from paddle_tpu_torch.ops import collectives
from paddle_tpu_torch.pir.analysis import (DEFAULT_INTERCONNECT, CostModel,
                                           OpCost)
from paddle_tpu_torch.pir.overlap import CollectiveOverlap
from torch_one_thread import one_torch_thread  # noqa: F401

F = torch.ops._c10d_functional


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo world: the functional collectives run eagerly."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    yield tdist.group.WORLD.group_name
    tdist.destroy_process_group()


def _overlap_fn(name):
    """Independent compute captured BEFORE the all-reduce of a partial
    product (the reference's tp_matmul case): hoisting the collective to
    just after its operand widens its window over that compute."""
    def f(x, w, y):
        p = x @ w
        b = torch.tanh(y) @ y.T
        c = torch.sin(y) @ y
        a = F.wait_tensor(F.all_reduce(p, "sum", name))
        return (a * 2.0 + b + c,)
    return f


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(*s).astype(np.float32)) * f
            for s, f in (((32, 64), 1.0), ((64, 32), 0.01),
                         ((32, 32), 0.5))]


def _names(prog):
    return [op.target.overloadpacket.__name__ if op.target is not None
            else op.name for op in prog.ops]


@pytest.mark.parametrize("op,factor", [
    ("all_reduce", 2.0), ("all_gather_into_tensor", 1.0),
    ("reduce_scatter_tensor", 1.0), ("all_to_all_single", 1.0)])
def test_traffic_factor_times_the_wider_side(op, factor):
    """Each collective's wire bytes are the reference's factor times the
    larger of its input and output bytes; its wait costs nothing."""
    def f(x):
        if op == "all_reduce":
            y = F.all_reduce(x, "sum", "0")
        elif op == "all_gather_into_tensor":
            y = F.all_gather_into_tensor(x, 4, "0")
        elif op == "reduce_scatter_tensor":
            y = F.reduce_scatter_tensor(x, "sum", 4, "0")
        else:
            y = F.all_to_all_single(x, [2, 2, 2, 2], [2, 2, 2, 2], "0")
        return (F.wait_tensor(y) + 1.0,)
    prog, _ = pir.capture(f, torch.ones(8, 16))
    coll = next(o for o in prog.ops if collectives.is_collective_op(o))
    wait = next(o for o in prog.ops if collectives.is_wait_op(o))
    wide = max(CostModel._value_bytes(coll.inputs),
               CostModel._value_bytes(coll.outputs))
    assert collectives.collective_traffic(coll) == [(op, factor * wide)]
    cm = CostModel()
    assert cm.comm_seconds(coll) == factor * wide / 4.5e11
    assert cm.comm_seconds(wait) == 0.0
    assert cm.run(prog)[id(wait)].flops == cm.run(prog)[id(wait)].bytes == 0


def test_nvlink_row_prices_a_program_holding_a_collective():
    """The interconnect row is the H100 SXM's NVLink data-sheet figure,
    under the reference's keys; reference-style overrides bind; a program
    with an all-reduce has comm seconds above 0 on its ProgramCost."""
    assert DEFAULT_INTERCONNECT == {"ici_bps": 4.5e11,
                                    "link_latency_s": 0.0}
    assert set(DEFAULT_INTERCONNECT) == set(janalysis.DEFAULT_INTERCONNECT)
    prog, _ = pir.capture(_overlap_fn("0"), *_inputs())
    cost = CostModel().analyze(prog)
    assert cost.comm_seconds == pytest.approx(2.0 * 32 * 32 * 4 / 4.5e11)
    assert cost.summary()["comm_seconds"] == cost.comm_seconds
    slow = CostModel(interconnect={"ici_bps": 4.5e10,
                                   "link_latency_s": 1e-6}).analyze(prog)
    assert slow.comm_seconds == pytest.approx(
        2.0 * 32 * 32 * 4 / 4.5e10 + 1e-6)
    plain, _ = pir.capture(lambda x: (x * 2.0,), torch.ones(4))
    assert CostModel().analyze(plain).comm_seconds == 0.0


def test_exposed_comm_is_the_reference_formula(monkeypatch):
    """The reference's exposed_comm_seconds, run over the same ops with the
    port's per-op comm and compute, gives the port's figure: the window of
    a collective runs to the first reader of its wait's result, which is
    where the reference's program (no wait) reads the collective's."""
    prog, _ = pir.capture(_overlap_fn("0"), *_inputs())
    cm = CostModel(roofline={"peak_flops": 1e9, "hbm_bps": 1e9},
                   interconnect={"ici_bps": 1e7, "link_latency_s": 1e-6})
    for order in ("captured", "hoisted"):
        if order == "hoisted":
            CollectiveOverlap(cm).run(prog)
        facts = cm.run(prog)
        mine = cm.exposed_comm_seconds(prog, facts)
        # the reference's view: each wait dropped, its reader reading the
        # collective's result
        subst = {id(w.outputs[0]): w.inputs[0] for w in prog.ops
                 if collectives.is_wait_op(w)}
        ops = [types.SimpleNamespace(
            inputs=[subst.get(id(v), v) for v in op.inputs],
            outputs=op.outputs, orig=op) for op in prog.ops
            if not collectives.is_wait_op(op)]
        view = types.SimpleNamespace(ops=ops)
        monkeypatch.setattr(janalysis.CostModel, "comm_seconds",
                            lambda self, op: cm.comm_seconds(op.orig))
        ref = janalysis.CostModel(roofline=cm.roofline,
                                  interconnect=cm.interconnect)
        theirs = ref.exposed_comm_seconds(
            view, {id(o): OpCost(facts[id(o.orig)].flops,
                                 facts[id(o.orig)].bytes) for o in ops})
        assert mine == pytest.approx(theirs, rel=1e-12)
        assert mine["collectives"] == 1 and mine["comm_seconds"] > 0


def test_overlap_hoists_and_keeps_numerics(group):
    """Hoisting the all-reduce strictly cuts the exposed term, the
    verifier stays clean, and the reordered replay equals eager bit for
    bit (a pure reorder) under a one-rank gloo group."""
    f = _overlap_fn(group)
    args = _inputs()
    prog, _ = pir.capture(f, *args, name="tp_overlap")
    cm = CostModel()
    before = cm.exposed_comm_seconds(prog)["exposed_seconds"]
    res = CollectiveOverlap(cm).run(prog)
    after = cm.exposed_comm_seconds(prog)["exposed_seconds"]
    assert res.edits >= 1
    assert after < before
    names = _names(prog)
    assert names.index("all_reduce") == names.index("mm") + 1
    assert names.index("wait_tensor") > names.index("all_reduce") + 2
    pir.verify_program(prog, where="overlap")
    assert torch.equal(prog.bind(*args)[0], f(*args)[0])


def test_overlap_declines_when_not_profitable(group):
    """A collective already at the front has nothing to hide behind: zero
    edits and the captured order kept."""
    def f(x, w):
        return (F.wait_tensor(F.all_reduce(x, "sum", group)) @ w * 2.0,)
    x, w = torch.ones(32, 64), torch.ones(64, 32) * 0.01
    prog, _ = pir.capture(f, x, w, name="tp_front")
    order = [id(op) for op in prog.ops]
    res = CollectiveOverlap().run(prog)
    assert res.edits == 0
    assert [id(op) for op in prog.ops] == order
    assert torch.equal(prog.bind(x, w)[0], f(x, w)[0])


def test_overlap_never_crosses_an_in_place_write():
    """An op touching a buffer some in-place op writes is a barrier (as
    for fold and CSE): the collective stays behind it."""
    def f(x, y):
        y.add_(1.0)
        z = torch.tanh(y) @ y
        return (F.wait_tensor(F.all_reduce(x, "sum", "0")) + z,)
    prog, _ = pir.capture(f, torch.ones(8, 8), torch.ones(8, 8))
    before = _names(prog)
    res = CollectiveOverlap().run(prog)
    assert res.edits == 0 and _names(prog) == before


def test_passes_leave_collectives_in_place():
    """Constant folding never evaluates a collective, even over a
    constant; the default pipeline keeps it and its wait."""
    def f(x):
        c = torch.ones(4, 4)
        return (F.wait_tensor(F.all_reduce(c, "sum", "0")) + x,)
    prog, _ = pir.capture(f, torch.ones(4, 4))
    pir.PassManager.default().run(prog)
    assert {"all_reduce", "wait_tensor"} <= set(_names(prog))


def test_eager_collectives_of_a_world_of_one_record_nothing():
    """The port's eager collectives (distributed/collective.py) in a world
    of one are the identity: a capture records no op of theirs, so they
    are not captured collectives."""
    from paddle_tpu_torch.distributed import collective

    def f(x):
        y = x * 2.0
        collective.all_reduce(y)
        return (y,)
    prog, _ = pir.capture(f, torch.ones(4))
    assert _names(prog) == ["mul"]
    assert CostModel().analyze(prog).comm_seconds == 0.0
