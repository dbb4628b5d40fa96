"""The port's PIR sharding passes against paddle_tpu.pir on the CPU.

The reference side runs on the 8 virtual CPU devices of tests/conftest.py
under a 2x2 `jax.sharding.Mesh` ("dp", "mp"); the port side under
ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"]). Inputs come from
numpy.random.RandomState(seed). Cases mirror tests/test_pir_sharding.py:
the propagation goldens (the Megatron MLP, the two-layer MLP annotated on
its weights only, two annotations clashing at an add), the search's three
decisions and its candidate order at one shared roofline and
interconnect row, the `compile.shard_prop` fault, and the compile cache's
keys and artifacts. Replays are held to eager at fp32 rtol 2e-5, atol
2e-6, the reference tests' tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.pir import analysis as janalysis
from paddle_tpu.pir import shard_prop as jshard_prop
from paddle_tpu.pir.capture import capture as jcapture
from paddle_tpu.pir.passes import PassManager as JPassManager
from paddle_tpu.pir.pipeline import compile_flat as jcompile_flat
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import pir
from paddle_tpu_torch.distributed import ProcessMesh
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.pir import analysis, shard_prop, shard_search
from paddle_tpu_torch.pir.serialize import dumps, loads
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-6)


def _jmesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))


def _mesh():
    return ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"], device="cpu")


def _arrays(seed, *shapes, scale=None):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*s).astype(np.float32) for s in shapes]
    if scale is not None:
        out = [a * np.float32(f) for a, f in zip(out, scale)]
    return out


def _jdots(prog):
    return [op.outputs[0] for op in prog.ops if op.eqn is not None
            and op.eqn.primitive.name == "dot_general"]


def _dots(prog):
    return [op.outputs[0] for op in prog.ops if op.target is not None
            and op.target.overloadpacket.__name__ in ("mm", "bmm", "addmm")]


def _both(jfn, fn, arrays, specs, name):
    """Capture and run the pipeline on both sides under their meshes;
    returns (reference program, port program, port replay, eager)."""
    jprog, _ = jcapture(jfn, *[jnp.asarray(a) for a in arrays], name=name)
    with jshard_prop.mesh_scope(_jmesh()):
        jshard_prop.annotate_inputs(jprog, specs)
        JPassManager.default().run(jprog)
    ts = [torch.tensor(a) for a in arrays]
    prog, _ = pir.capture(fn, *ts, name=name)
    with shard_prop.mesh_scope(_mesh()):
        shard_prop.annotate_inputs(prog, specs)
        pir.PassManager.default().run(prog)
        pir.verify_program(prog, where="passes")
        out = prog.bind(*ts)[0]
    return jprog, prog, out, fn(*ts)[0]


def test_llama_mlp_block_matches_reference():
    """Megatron annotations (column-parallel gate/up, row-parallel down,
    dp activations) give the reference's three product specs and a fully
    annotated interior."""
    def jmlp(x, g, u, d):
        return (jax.nn.silu(x @ g) * (x @ u)) @ d

    def mlp(x, g, u, d):
        return (torch.nn.functional.silu(x @ g) * (x @ u) @ d,)
    arrays = _arrays(0, (8, 16), (16, 32), (16, 32), (32, 16),
                     scale=(1, .1, .1, .1))
    specs = [("dp", None), (None, "mp"), (None, "mp"), ("mp", None)]
    jprog, prog, out, want = _both(jmlp, mlp, arrays, specs, "llama_mlp")
    assert [v.sharding for v in _dots(prog)] == \
        [v.sharding for v in _jdots(jprog)] == \
        [("dp", "mp"), ("dp", "mp"), ("dp", None)]
    assert [v.sharding for v in prog.outputs] == \
        [v.sharding for v in jprog.outputs]
    assert all(o.sharding is not None for op in prog.ops
               for o in op.outputs)
    torch.testing.assert_close(out, want, **TOL)
    # the replay hint marks the result with its DTensor placements
    assert [str(p) for p in out.placements] == ["Shard(dim=0)",
                                                "Replicate()"]


def test_two_layer_mlp_weights_only_matches_reference():
    """Only the weights are annotated: the activations' specs flow
    backward and forward from them, as in the reference."""
    def jf(x, w1, w2):
        return (jnp.tanh(x @ w1) @ w2).sum(-1)

    def f(x, w1, w2):
        return ((torch.tanh(x @ w1) @ w2).sum(-1),)
    arrays = _arrays(1, (8, 16), (16, 32), (32, 16), scale=(1, .1, .1))
    specs = [None, (None, "mp"), ("mp", None)]
    jprog, prog, out, want = _both(jf, f, arrays, specs, "mlp2")
    assert [v.sharding for v in _dots(prog)] == \
        [v.sharding for v in _jdots(jprog)] == [(None, "mp"), (None, None)]
    assert [v.sharding for v in prog.outputs] == \
        [v.sharding for v in jprog.outputs]
    assert prog.inputs[0].sharding == jprog.inputs[0].sharding
    assert all(o.sharding is not None for op in prog.ops
               for o in op.outputs)
    torch.testing.assert_close(out, want, **TOL)


def test_conflicting_annotations_resolve_like_reference():
    """Two annotations meeting at an add resolve by reshard price to the
    reference's winner, stamped as a reshard contract the verifier
    accepts."""
    def f(a, b):
        return (torch.tanh(a + b),)
    arrays = _arrays(2, (8, 8), (8, 8))
    specs = [("dp", None), (None, "mp")]
    jprog, prog, out, want = _both(lambda a, b: jnp.tanh(a + b), f, arrays,
                                   specs, "clash")
    add = next(op for op in prog.ops if op.name == "aten.add.Tensor")
    jadd = next(op for op in jprog.ops if op.eqn is not None
                and op.eqn.primitive.name == "add")
    assert add.attrs["sharding_rule"] == jadd.attrs["sharding_rule"]
    assert add.attrs["sharding_rule"].startswith("reshard")
    assert [v.sharding for v in prog.outputs] == \
        [v.sharding for v in jprog.outputs]
    torch.testing.assert_close(out, want, **TOL)


def test_broadcast_operand_joins_right_aligned():
    """x[8, 16] + b[16] under ("dp", None): aten broadcasts inside the add,
    so b's spec right-aligns and no conflict (nor reshard stamp) arises;
    the reference spells the broadcast out and gets the same result."""
    def f(x, b):
        return (torch.tanh(x + b),)
    arrays = _arrays(3, (8, 16), (16,))
    jprog, prog, out, want = _both(lambda x, b: jnp.tanh(x + b), f, arrays,
                                   [("dp", None), (None,)], "bcast")
    assert not any("sharding_rule" in op.attrs for op in prog.ops)
    assert [v.sharding for v in prog.outputs] == \
        [v.sharding for v in jprog.outputs] == [("dp", None)]
    torch.testing.assert_close(out, want, **TOL)


def test_printer_and_views_carry_sharding():
    """The printer shows the specs, and a 3-d activation keeps its batch
    spec through make_fx's view + mm + view."""
    def f(x, w):
        return (torch.tanh(x @ w),)
    x, w = (torch.tensor(a) for a in _arrays(4, (2, 4, 16), (16, 32)))
    prog, _ = pir.capture(f, x, w)
    with shard_prop.mesh_scope(_mesh()):
        shard_prop.annotate_inputs(prog, [("dp", None, None), (None, "mp")])
        pir.PassManager.default().run(prog)
    text = prog.to_string()
    assert "<dp,*,*>" in text and "<dp,*,mp>" in text
    assert prog.outputs[0].sharding == ("dp", None, "mp")


_SEARCH = [
    ("dp", [("dp", None), (None, None), (None, None)]),
    ("tp", [(None, None), (None, "mp"), ("mp", None)]),
    ("dp+tp", [("dp", None), (None, "mp"), ("mp", None)]),
]


@pytest.fixture
def one_row(monkeypatch):
    """The reference's roofline and interconnect dicts on both sides, so
    the port's H100 rows do not shift the decision: the search is held to
    the reference's arithmetic and its three outcomes. (At the H100 rows
    both sides keep the 512x1024x2048 MLP replicated, with equal prices.)"""
    monkeypatch.setattr(analysis, "DEFAULT_ROOFLINE",
                        dict(janalysis.DEFAULT_ROOFLINE))
    monkeypatch.setattr(analysis, "DEFAULT_INTERCONNECT",
                        dict(janalysis.DEFAULT_INTERCONNECT))


@pytest.mark.parametrize("case", ["dp", "replicated", "user"])
def test_search_decision_matches_reference(case, one_row):
    """The reference's three cases: the 512x1024x2048 MLP picks dp, an
    8x8 product stays replicated, a user-annotated input declines."""
    shapes, space, given, want = {
        "dp": ([(512, 1024), (1024, 2048), (2048, 1024)], _SEARCH, None,
               "dp"),
        "replicated": ([(8, 8), (8, 8)], [("tp", [(None, None),
                                                  (None, "mp")])],
                       None, "replicated"),
        "user": ([(8, 16), (16, 32)], [("tp", [(None, None),
                                               (None, "mp")])],
                 [("dp", None), None], None),
    }[case]
    arrays = _arrays(5, *shapes, scale=[.01] * len(shapes))

    def jf(*a):
        return ((jnp.tanh(a[0] @ a[1]) @ a[2]).sum(-1),) if len(a) == 3 \
            else (a[0] @ a[1],)

    def f(*a):
        return ((torch.tanh(a[0] @ a[1]) @ a[2]).sum(-1),) if len(a) == 3 \
            else (a[0] @ a[1],)
    with jshard_prop.mesh_scope(_jmesh(), search=space):
        _, jrep = jcompile_flat(jf, [jnp.asarray(a) for a in arrays],
                                name=f"search_{case}",
                                input_shardings=given)
    ts = [torch.tensor(a) for a in arrays]
    with shard_prop.mesh_scope(_mesh(), search=space):
        fn, rep = pir.compile_flat(f, ts, name=f"search_{case}",
                                   input_shardings=given)
        out = fn(*ts)[0]
    assert rep.shard_decision == jrep.shard_decision == want
    if want is not None:
        assert rep.summary()["shard_decision"] == want
        assert rep.shard_predicted_s > 0
    torch.testing.assert_close(out, f(*ts)[0], **TOL)


def test_search_candidate_order_matches_reference(one_row):
    """Every candidate's predicted seconds rank in the reference's order
    (the implicit replicated one included)."""
    arrays = _arrays(6, (512, 1024), (1024, 2048), (2048, 1024),
                     scale=(.01, .01, .01))
    jprog, _ = jcapture(lambda x, a, b: (jnp.tanh(x @ a) @ b).sum(-1),
                        *[jnp.asarray(a) for a in arrays])
    with jshard_prop.mesh_scope(_jmesh(), search=_SEARCH):
        from paddle_tpu.pir.shard_search import ShardingSearch as JSearch
        JSearch().run(jprog)
    prog, _ = pir.capture(lambda x, a, b: ((torch.tanh(x @ a) @ b).sum(-1),),
                          *[torch.tensor(a) for a in arrays])
    with shard_prop.mesh_scope(_mesh(), search=_SEARCH):
        res = shard_search.ShardingSearch().run(prog)
    mine, ref = prog._shard_search["candidates"], \
        jprog._shard_search["candidates"]
    assert sorted(mine, key=mine.get) == sorted(ref, key=ref.get)
    assert mine == pytest.approx(ref, rel=1e-9)
    assert res.edits == 3 and prog.inputs[0].sharding == ("dp", None)


def test_search_scope_keeps_products_out_of_fused_regions():
    """Epilogue absorption is off while a search scope is active (the
    search prices a sharded contraction off the product ops)."""
    def f(x, w):
        return (torch.tanh(x @ w) * 2.0,)
    ts = [torch.tensor(a) for a in _arrays(7, (8, 16), (16, 32))]
    names = []
    for scope in (None, [("tp", [(None, None), (None, "mp")])]):
        prog, _ = pir.capture(f, *ts)
        with shard_prop.mesh_scope(_mesh(), search=scope):
            pir.FusionPass().run(prog)
        names.append([op.name for op in prog.ops])
    assert "aten.mm.default" not in names[0]
    assert "aten.mm.default" in names[1]


def _counter(name, **labels):
    fam = obs.get_registry().get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


def test_shard_prop_fault_degrades_and_clean_retry_shards():
    """An injected compile.shard_prop failure runs that compile as
    written (stage passes, counted, right); the clean retry shards."""
    def f(x, w):
        return (torch.tanh(x @ w).sum(),)
    ts = [torch.ones(8, 16), torch.ones(16, 32) * 0.1]
    want = f(*ts)[0]
    specs = [("dp", None), (None, "mp")]
    obs.get_registry().reset()
    obs.enable()
    try:
        base = _counter("pir_fallback_total", stage="passes")
        _flags.set_flags(
            {"fault_injection": "compile.shard_prop:1:RuntimeError"})
        try:
            with shard_prop.mesh_scope(_mesh()), pytest.warns(
                    RuntimeWarning, match="stage 'passes'"):
                fn, rep = pir.compile_flat(f, ts, name="faulted",
                                           input_shardings=specs)
                out = fn(*ts)[0]
        finally:
            _flags.set_flags({"fault_injection": ""})
        assert rep.fallback == "passes"
        assert _counter("pir_fallback_total", stage="passes") == base + 1
    finally:
        obs.disable()
        obs.get_registry().reset()
    torch.testing.assert_close(out, want, **TOL)
    with shard_prop.mesh_scope(_mesh()):
        fn2, rep2 = pir.compile_flat(f, ts, name="faulted",
                                     input_shardings=specs)
        out2 = fn2(*ts)[0]
    assert rep2.fallback is None
    assert rep2.pass_report["shard_prop"]["edits"] > 0
    torch.testing.assert_close(out2, want, **TOL)


def test_artifact_keeps_every_sharding_and_rule():
    """serialize round trip: every Value.sharding and sharding_rule of an
    annotated program survives, and the loaded program replays alike."""
    def f(a, b, w):
        return (torch.tanh(a + b) @ w,)
    arrays = _arrays(8, (8, 8), (8, 8), (8, 16))
    ts = [torch.tensor(a) for a in arrays]
    prog, _ = pir.capture(f, *ts, name="round_trip")
    with shard_prop.mesh_scope(_mesh()):
        shard_prop.annotate_inputs(prog, [("dp", None), (None, "mp"), None])
        pir.PassManager.default().run(prog)
    back = loads(dumps(prog))

    def values(p):
        return [v.sharding for v in p.inputs] + [
            o.sharding for op in p.ops for o in op.outputs]
    assert values(back) == values(prog)
    assert any(s is not None for s in values(prog))
    assert [op.attrs.get("sharding_rule") for op in back.ops] == \
        [op.attrs.get("sharding_rule") for op in prog.ops]
    assert any(op.attrs.get("sharding_rule") for op in prog.ops)
    torch.testing.assert_close(back.bind(*ts)[0], prog.bind(*ts)[0],
                               rtol=0, atol=0)


def test_cache_key_differs_between_meshes_and_hit_is_annotated(tmp_path):
    def f(x, w):
        return (torch.tanh(x @ w),)
    ts = [torch.tensor(a) for a in _arrays(9, (8, 16), (16, 32))]
    specs = [("dp", None), (None, "mp")]
    prev = _flags.flag_value("compile_cache_dir")
    _flags.set_flags({"compile_cache_dir": str(tmp_path)})
    try:
        keys = []
        for mesh in (_mesh(), ProcessMesh([[0, 1, 2, 3]], ["dp", "mp"],
                                          device="cpu")):
            with shard_prop.mesh_scope(mesh):
                _, rep = pir.compile_flat(f, ts, name="keyed",
                                          input_shardings=specs)
            keys.append(rep.key)
            assert rep.cache == "miss"
        with shard_prop.mesh_scope(_mesh()):
            warm, rep = pir.compile_flat(f, ts, name="keyed",
                                         input_shardings=specs)
            out = warm(*ts)[0]
        _, plain = pir.compile_flat(f, ts, name="keyed")
    finally:
        _flags.set_flags({"compile_cache_dir": prev})
    assert keys[0] != keys[1] and plain.key not in keys
    assert rep.cache == "hit" and rep.key == keys[0]
    assert rep.program.outputs[0].sharding == ("dp", "mp")
    assert [str(p) for p in out.placements] == ["Shard(dim=0)",
                                                "Shard(dim=1)"]
    torch.testing.assert_close(out, f(*ts)[0], **TOL)


def test_pir_jit_sharding_rules_on_llama():
    """pir_jit(sharding_rules=LLAMA_SHARDING_RULES) under the 2x2 mesh:
    the parameters are annotated by path and propagated, and the loss and
    every gradient equal the same step compiled outside the scope bit for
    bit (the scope adds only the replay hint). Against eager, the step is
    held at rtol 1e-5, atol 1e-7: fusion walls at annotated values change
    the replay's op order, and so autograd's accumulation order."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import spmd
    pt.seed(0)
    m = pt.models.llama_tiny(device="cpu", num_hidden_layers=1)
    params = dict(m.named_parameters())
    ids = torch.as_tensor(np.random.RandomState(10).randint(0, 512, (2, 8)))

    def step(params, ids):
        return torch.func.functional_call(m, params, (ids,),
                                          {"labels": ids})[0]
    out = []
    for scope in (None, _mesh(), "eager"):
        fn = pir.pir_jit(step, name="llama_step",
                         sharding_rules=spmd.LLAMA_SHARDING_RULES)
        if scope == "eager":
            fn = step
        with shard_prop.mesh_scope(scope if scope != "eager" else None):
            loss = fn(params, ids)
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append((loss, grads, getattr(fn, "report", None)))
    (l0, g0, r0), (l1, g1, r1), (le, ge, _) = out
    assert r1.pass_report["shard_prop"]["edits"] > 0
    assert r0.program._mesh is None and r1.program._mesh is not None
    q = next(i for i, k in enumerate(params) if k.endswith("q_proj.weight"))
    assert r1.program.inputs[q].sharding == (None, "mp")
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert hasattr(l1, "placements") and not hasattr(l0, "placements")
    torch.testing.assert_close(l1, le, rtol=1e-5, atol=1e-7)
    for a, b in zip(g1, ge):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_passes_flag_default_is_the_reference_order():
    from paddle_tpu.framework import flags as jflags
    assert _flags.flag_value("pir_passes") == jflags.flag_value("pir_passes")
    assert [p.name for p in pir.PassManager.default().passes] == [
        "fold", "cse", "pattern", "fuse", "dce", "shard_search",
        "shard_prop", "overlap"]
    # every sharding pass declines at once without a scope or annotations
    prog, _ = pir.capture(lambda x: (x * 2.0,), torch.ones(4))
    report = pir.PassManager.default().run(prog)
    assert [report[n]["notes"] for n in ("shard_search", "shard_prop",
                                         "overlap")] == \
        ["no-search-scope", "no-annotations", "no-collectives"]
