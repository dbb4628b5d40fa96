"""The port's PIR passes on the CPU: DCE, constant folding and CSE each on a
program built to need them, the DRR patterns (SdpaRoutePattern fires on
dense causal attention and never on a padding mask; RmsEpiloguePattern
fires on the unfused epilogue), the fusion pass and its walls, the pass
flag, the catalog metrics, `tools/ir_dump.py --all --check` and
`tools/pipeline_tax.py` at a cut size.

No assertion here is one of the five reference tests that fail on the
reference itself (ROADMAP.md, "The reference itself is not green"): the
patterns are held to the port's own captured graphs and to the dense
math, not to the reference's pattern counts.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import pir
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.incubate.nn import functional as inc
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-6, atol=2e-6)   # float32 replays of the same ops


def _run(prog, *names):
    return {n: dict(zip(("edits", "notes"), (r.edits, r.notes)))
            for n, r in ((p.name, p.run(prog))
                         for p in pir.PassManager.default().passes
                         if p.name in names)}


def _rand(*shape, seed=0):
    return torch.tensor(np.random.RandomState(seed).randn(*shape),
                        dtype=torch.float32)


def _dense_attention(q, k, v, mask=None):
    """Hand-written causal attention: einsum, scale, tril mask, softmax,
    einsum (the reference tests' dense form, in torch)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    sq, sk = q.shape[1], k.shape[1]
    keep = torch.ones(sq, sk, dtype=torch.bool).tril() if mask is None \
        else mask
    s = s.masked_fill(~keep, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def test_dce_removes_dead_branch():
    def f(x):
        dead = torch.exp(x) * 3.0      # never returned
        del dead
        return (x + 1.0,)

    prog = pir.capture(f, _rand(4, 4))[0]
    # capture already drops pure dead nodes: plant one as a pass would
    live = prog.ops[-1]
    extra = pir.Operation("aten.exp.default", [prog.inputs[0]],
                          [prog.new_value((4, 4), torch.float32,
                                          device="cpu")],
                          eqn=(torch.ops.aten.exp.default,
                               ((pir.ir.Ref(0),), {})))
    prog.ops.insert(0, extra)
    n = prog.num_ops()
    res = pir.DeadCodeElimination().run(prog)
    assert res.edits == 1 and prog.num_ops() == n - 1
    assert prog.ops[-1] is live


def test_cse_merges_duplicate_products():
    def f(x, w):
        return (x @ w + x @ w,)

    prog = pir.capture(f, _rand(4, 4), _rand(4, 4, seed=1))[0]
    before = sum(op.name == "aten.mm.default" for op in prog.ops)
    res = pir.CommonSubexprElimination().run(prog)
    assert before == 2 and res.edits == 1
    assert sum(op.name == "aten.mm.default" for op in prog.ops) == 1
    x, w = _rand(4, 4), _rand(4, 4, seed=1)
    assert torch.equal(prog.bind(x, w)[0], f(x, w)[0])


def test_constant_folding_turns_tables_into_constants():
    def f(x):
        t = torch.arange(8.0).reshape(2, 4).exp()
        m = torch.ones(4, 4, dtype=torch.bool).tril()
        return (x * t.sum() + m.float(),)

    prog = pir.capture(f, _rand(4, 4))[0]
    res = pir.ConstantFolding().run(prog)
    assert res.edits >= 6 and "ops_folded" in res.notes
    assert all(op.inputs for op in prog.ops)      # no factory left
    x = _rand(4, 4)
    torch.testing.assert_close(prog.bind(x)[0], f(x)[0], **TOL)


def test_passes_flag_toggles_and_unknown_pass_raises():
    prev = _flags.flag_value("pir_passes")
    try:
        _flags.set_flags({"pir_passes": "dce,cse"})
        assert [p.name for p in pir.PassManager.default().passes] == \
            ["dce", "cse"]
        _flags.set_flags({"pir_passes": "fold,shard_prop"})
        assert [p.name for p in pir.PassManager.default().passes] == \
            ["fold", "shard_prop"]
        _flags.set_flags({"pir_passes": "fold,shard_propagation"})
        with pytest.raises(ValueError, match="unknown PIR pass"):
            pir.PassManager.default()
    finally:
        _flags.set_flags({"pir_passes": prev})
    assert prev == "fold,cse,pattern,fuse,dce,shard_search,shard_prop,overlap"


def test_pass_metrics_flow_through_catalog():
    obs.get_registry().reset()
    obs.enable()
    try:
        def f(x):
            return (torch.ones(4, 4).tril() * x,)
        prog = pir.capture(f, _rand(4, 4))[0]
        pir.PassManager.default().run(prog)
        reg = obs.get_registry()
        assert reg.get("pir_pass_edits_total").labels(
            **{"pass": "fold"}).value >= 2
        assert reg.get("pir_pass_seconds").labels(
            **{"pass": "dce"}).count == 1
        assert reg.get("pir_captures_total").value >= 1
    finally:
        obs.disable()
        obs.get_registry().reset()


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_sdpa_fires_on_dense_causal_attention(heads):
    h, kvh = heads

    def f(q, k, v):
        rep = h // kvh
        k2, v2 = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        return (_dense_attention(q, k2, v2),)

    q, k, v = _rand(2, 16, h, 8), _rand(2, 16, kvh, 8, seed=1), \
        _rand(2, 16, kvh, 8, seed=2)
    prog = pir.capture(f, q, k, v)[0]
    rep = _run(prog, "fold", "cse", "pattern", "dce")
    assert rep["pattern"]["notes"] == "sdpa_route=1"
    op = next(o for o in prog.ops if o.name == "pt.sdpa")
    assert op.attrs["causal"] is True
    assert op.attrs["scale"] == pytest.approx(1 / 8 ** 0.5)
    assert op.attrs["route_fwd"] == "replay"          # off the card
    assert op.inputs[1].shape == (2, 16, kvh, 8)       # GQA-native k
    pir.verify_program(prog)
    torch.testing.assert_close(prog.bind(q, k, v)[0], f(q, k, v)[0], **TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto", "broken"])
def test_sdpa_route_is_the_eager_decision(backend, monkeypatch):
    """pt.sdpa takes K1 exactly where eager attention would
    (`_use_pallas`, FLAGS_flash_attention_backend included), and a router
    that raises under 'auto' fails the rewrite instead of replaying."""
    from types import SimpleNamespace
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.ops import attention_router as ar
    from paddle_tpu_torch.pir import patterns
    q = SimpleNamespace(dtype=torch.bfloat16, device=torch.device("cuda"))
    if backend == "broken":
        def broken(*a, **kw):
            raise RuntimeError("no measurement")
        monkeypatch.setattr(ar, "route", broken)
    else:
        monkeypatch.setattr(ar, "route", lambda *a, **kw: ar.Decision(
            fwd="xla", bwd="xla"))
    _flags.set_flags({"FLAGS_flash_attention_backend":
                      "auto" if backend == "broken" else backend})
    try:
        if backend == "broken":
            with pytest.raises(RuntimeError, match="no measurement"):
                patterns._route(2, 512, 4, 128, q, True)
            return
        want = attn._use_pallas((2, 512, 4, 128), 128, False,
                                dtype=q.dtype, causal=True, device=q.device)
        got, source = patterns._route(2, 512, 4, 128, q, True)
        assert got == ("flash" if want else "replay")
        assert got == ("flash" if backend == "pallas" else "replay")
        assert source == f"backend={backend}"
    finally:
        _flags.set_flags({"FLAGS_flash_attention_backend": "auto"})


@pytest.mark.parametrize("mask", ["padding", "window", "none"])
def test_sdpa_never_claims_a_non_causal_mask(mask):
    """A padding-style (or banded) constant mask, or no mask at all,
    is not the causal mask: the pattern must not fire as causal."""
    s = 16

    def f(q, k, v):
        if mask == "none":
            p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
            return (torch.einsum("bhqk,bkhd->bqhd", p, v),)
        keep = torch.ones(s, s, dtype=torch.bool)
        if mask == "padding":
            keep[:, 12:] = False
        else:
            keep = keep.tril() & ~keep.tril(-4)
        return (_dense_attention(q, k, v, keep),)

    q, k, v = (_rand(1, s, 2, 8, seed=i) for i in range(3))
    prog = pir.capture(f, q, k, v)[0]
    _run(prog, "fold", "cse", "pattern", "dce")
    sdpa = [o for o in prog.ops if o.name == "pt.sdpa"]
    assert all(not o.attrs["causal"] for o in sdpa)
    if mask != "none":
        assert sdpa == []
    torch.testing.assert_close(prog.bind(q, k, v)[0], f(q, k, v)[0], **TOL)


def test_rms_epilogue_fires_on_the_unfused_epilogue():
    b, s, h, d = 1, 16, 4, 8
    q, k, v, res = (_rand(b, s, h, d, seed=i) for i in range(4))
    w = torch.rand(d, generator=torch.Generator().manual_seed(4))

    def f(q_, k_, v_, r_, w_):
        return (inc.fused_attention_rms_epilogue(q_, k_, v_, r_, w_),)

    prog = pir.capture(f, q, k, v, res, w)[0]
    rep = _run(prog, "fold", "cse", "pattern", "dce")
    assert rep["pattern"]["notes"] == "rms_epilogue=1 sdpa_route=1"
    assert [o.name for o in prog.ops] == ["pt.sdpa_rms_epilogue"]
    op = prog.ops[0]
    assert op.attrs["eps"] == pytest.approx(1e-6) and op.attrs["causal"]
    torch.testing.assert_close(prog.bind(q, k, v, res, w)[0],
                               f(q, k, v, res, w)[0], **TOL)


def _fused_mlp(x, w1, w2, g):
    hh = torch.nn.functional.gelu(x @ w1)
    y = hh @ w2 + x
    var = (y * y).mean(-1, keepdim=True)
    return (y * torch.rsqrt(var + 1e-6) * g, y)


def _fused_mlp_args():
    return [_rand(8, 32), _rand(32, 64, seed=1) * 0.1,
            _rand(64, 32, seed=2) * 0.1, torch.rand(32)]


def test_fusion_groups_commit_and_replay_bit_for_bit():
    args = _fused_mlp_args()
    prog = pir.capture(_fused_mlp, *args, name="fused_mlp")[0]
    want = _fused_mlp(*args)
    cost = pir.CostModel()
    before = cost.analyze(prog)
    rep = _run(prog, "fuse", "dce")
    fused = [o for o in prog.ops if o.name == "pt.fused_region"]
    assert fused and rep["fuse"]["edits"] == len(fused)
    kinds = {o.attrs["fusion_group"]["kind"] for o in fused}
    assert "epilogue" in kinds
    assert all(o.attrs["fusion_group"]["predicted_bytes_saved"] > 0
               for o in fused)
    # the regions replay op by op: priced at their members' own traffic,
    # no bytes reported saved
    assert "bytes_saved=0 " in rep["fuse"]["notes"]
    for o in fused:
        members = o.fn.body[1]
        assert o.attrs["fusion_group"]["bytes"] == sum(
            cost._op_cost(m).bytes for m in members)
    after = cost.analyze(prog)
    assert after.bytes >= before.bytes and after.flops == before.flops
    assert "fusion_group" in prog.to_string()
    got = prog.bind(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pir.verify_program(prog, strict_dead=True)


def test_fusion_never_crosses_pt_or_effect_ops():
    q, k, v = (_rand(1, 16, 2, 8, seed=i) for i in range(3))

    def f(q, k, v, pool):
        out = _dense_attention(q, k, v)
        with pir.effect_scope("kv.write"):
            pool.mul_(2.0)
        return (torch.tanh(out) * 2.0 + 1.0, pool.exp() + 1.0)

    prog = pir.capture(f, q, k, v, torch.ones(4, 4))[0]
    _run(prog, "fold", "cse", "pattern", "fuse", "dce")
    for op in prog.ops:
        fg = op.attrs.get("fusion_group")
        if fg:
            assert not any(n.startswith("pt.") or n.startswith("aten.mul_")
                           for n in fg["ops"])
    assert any(o.name == "pt.sdpa" for o in prog.ops)
    assert any(o.attrs.get("effect") for o in prog.ops)


def test_ir_dump_all_check_exits_zero(capsys):
    from paddle_tpu_torch.tools import ir_dump
    assert ir_dump.main(["--all", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("check OK") == len(ir_dump.EXAMPLES)
    assert "pt.sdpa_rms_epilogue" in out and "pt.sdpa" in out


def test_pipeline_tax_at_a_cut_size(monkeypatch, capsys):
    from paddle_tpu_torch.tools import pipeline_tax as tax
    monkeypatch.setattr(tax, "CFG", dict(
        hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=2, num_key_value_heads=2, vocab_size=64,
        max_position_embeddings=32))
    monkeypatch.setattr(tax, "BATCH", 4)
    monkeypatch.setattr(tax, "SEQ", 8)
    monkeypatch.setattr(tax, "STEPS", 1)
    monkeypatch.setattr(tax, "ROWS", ((2, 2),))
    assert tax.main(["--device", "cpu", "--workers", "0"]) == 0
    out = capsys.readouterr().out
    assert "| SpmdTrainer dp=2 | 2 | 2 |" in out and "| ZB pp=2 |" in out
    assert "n/a" not in out and "one after another" in out
