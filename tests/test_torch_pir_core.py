"""The port's PIR capture and IR (paddle_tpu_torch/pir: ir.py, capture.py,
the CostModel of analysis.py) and the K1 operator's autograd, against the
reference's (paddle_tpu/pir) on the CPU.

A to_static'd llama decoder block (the reference's `_tiny_llama_layer`
config, float32, the reference's weights) must match the reference's eager
block within 1e-5 and the port's own eager block bit for bit, its every
gradient too; the product flops of the port's CostModel must equal the
reference's on the same block exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import pir as ref_pir
from paddle_tpu.framework import core as _core
from paddle_tpu_torch import jit, pir
from paddle_tpu_torch.ops import flash_attention as fa
from torch_one_thread import one_torch_thread  # noqa: F401

REF_TOL = 1e-5    # float32 against the reference, different op order
# to_static gradients against eager's: CSE merges the three projections'
# identical views of the normed input, so their gradients are summed in
# another order (the forward stays bit for bit)
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-6


def _mlp():
    pt.seed(0)
    return pt.nn.Sequential(pt.nn.Linear(8, 16, device="cpu"), pt.nn.ReLU(),
                            pt.nn.Linear(16, 4, device="cpu"))


def _flat(layer, *inputs):
    names = [k for k, _ in layer.named_parameters()]
    params = [p.detach() for _, p in layer.named_parameters()]

    def flat_fn(*leaves):
        state = dict(zip(names, leaves[:len(names)]))
        return (torch.func.functional_call(layer, state,
                                           tuple(leaves[len(names):])),)

    return flat_fn, params + list(inputs)


CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=1, num_attention_heads=4,
           num_key_value_heads=2, dtype="float32")


@pytest.fixture(scope="module")
def block_pair():
    """(reference layer, port layer with the reference's weights, x)."""
    from paddle_tpu.models.llama import LlamaConfig, LlamaDecoderLayer
    from paddle_tpu_torch.models.llama import LlamaConfig as PC
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer as PL
    paddle.seed(0)
    ref = LlamaDecoderLayer(LlamaConfig(**CFG))
    ref.eval()
    port = PL(PC(**CFG), device="cpu")
    port.load_state_dict({k: torch.tensor(np.asarray(v._data))
                          for k, v in ref.state_dict().items()})
    x = np.random.RandomState(0).randn(1, 8, 32).astype(np.float32)
    return ref, port, x


def test_capture_and_print():
    model = _mlp()
    fn, flat = _flat(model, torch.ones(4, 8))
    prog, spec = pir.capture(fn, *flat, name="mlp")
    text = prog.to_string()
    assert "program @mlp" in text and "aten.mm.default" in text
    assert "return" in text and prog.num_ops() > 0
    assert len(prog.inputs) == len(flat)
    assert repr(prog).startswith("<pir.Program @mlp")


def test_bind_matches_eager_bit_for_bit():
    model = _mlp()
    x = torch.tensor(np.random.RandomState(0).randn(4, 8), dtype=torch.float32)
    fn, flat = _flat(model, x)
    prog, _ = pir.capture(fn, *flat, name="mlp")
    assert torch.equal(prog.bind(*flat)[0], fn(*flat)[0])


def test_canonical_hash_stable_and_content_sensitive():
    def f(x):
        return (torch.tanh(x) * 2.0,)

    def g(x):
        return (torch.tanh(x) * 3.0,)

    x = torch.ones(4, 4)
    h1 = pir.capture(f, x)[0].canonical_hash()
    h2 = pir.capture(f, x)[0].canonical_hash()
    assert h1 == h2
    assert pir.capture(g, x)[0].canonical_hash() != h1
    assert pir.capture(f, torch.ones(4, 5))[0].canonical_hash() != h1
    # closed-over constants hash by content, never by address
    c1, c2 = torch.arange(4.0), torch.arange(4.0)
    p1 = pir.capture(lambda x: (x + c1,), x)[0]
    p2 = pir.capture(lambda x: (x + c2,), x)[0]
    assert p1.canonical_hash() == p2.canonical_hash()
    assert "0x" not in p1.canonical_text()


def test_capture_runs_on_fake_tensors_and_breaks_on_data():
    seen = []

    def f(x):
        seen.append(type(x).__name__)
        return (x * 2,)

    pir.capture(f, torch.ones(3))
    assert seen == ["FakeTensor"]

    def branchy(x):
        if float(x.sum()) > 0:
            return (x * 2,)
        return (x - 1,)

    with pytest.raises(pir.GraphBreak, match="data-dependent"):
        pir.capture(branchy, torch.ones(3))


def test_llama_block_to_static_matches_reference_and_eager(block_pair):
    ref, port, x = block_pair
    want_ref = np.asarray(ref(paddle.Tensor(jnp.asarray(x)))._data)
    xt = torch.tensor(x)
    with torch.no_grad():
        want = port(xt)
    sf = jit.to_static(port.forward)
    with torch.no_grad():
        got = sf(xt)
    rep = sf.last_report
    assert rep.fallback is None
    assert rep.pattern_counts == {"sdpa_route": 1}
    assert rep.fusion_groups > 0 and rep.final_ops < rep.captured_ops
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=REF_TOL,
                               atol=REF_TOL)


def test_llama_block_to_static_gradients_match_eager(block_pair):
    _, port, x = block_pair
    xt = torch.tensor(x, requires_grad=True)
    port.zero_grad()
    (port(xt) ** 2).sum().backward()
    want = {k: p.grad.clone() for k, p in port.named_parameters()}
    want["x"] = xt.grad.clone()
    port.zero_grad()
    xs = torch.tensor(x, requires_grad=True)
    sf = jit.to_static(port.forward)
    (sf(xs) ** 2).sum().backward()
    assert sf.last_report.pattern_counts == {"sdpa_route": 1}
    got = {k: p.grad for k, p in port.named_parameters()}
    got["x"] = xs.grad
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=k)
    port.zero_grad()


def _ref_product_flops(jaxpr):
    """Sum of the reference CostModel's dot_general prices, nested
    jaxprs included."""
    from paddle_tpu.pir.analysis import _eqn_cost, _inner_jaxprs
    total = 0.0
    for eqn in jaxpr.eqns:
        inner = _inner_jaxprs(eqn.params)
        for j in inner:
            total += _ref_product_flops(j)
        if eqn.primitive.name == "dot_general":
            total += _eqn_cost(eqn)[0]
    return total


def test_cost_model_product_flops_equal_reference(block_pair):
    ref, port, x = block_pair
    params = [p for _, p in ref.named_parameters()]

    def ref_fn(*leaves):
        saved = [(t, t._data, t._node) for t in params]
        try:
            for t, a in zip(params, leaves[:len(params)]):
                t._data, t._node = a, None
            with _core.TraceContext():
                return (ref(paddle.Tensor(leaves[-1]))._data,)
        finally:
            for t, a, n in saved:
                t._data, t._node = a, n

    rprog, _ = ref_pir.capture(ref_fn, *[p._data for p in params],
                               jnp.asarray(x))
    want = sum(_ref_product_flops_eqn(op.eqn) for op in rprog.ops)
    fn, flat = _flat(port, torch.tensor(x))
    prog, _ = pir.capture(fn, *flat)
    facts = pir.CostModel().run(prog)
    got = sum(facts[id(op)].flops for op in prog.ops
              if op.target is not None and op.target.overloadpacket.__name__
              in ("mm", "bmm", "addmm", "baddbmm", "matmul"))
    assert want > 0 and got == want


def _ref_product_flops_eqn(eqn):
    from paddle_tpu.pir.analysis import _eqn_cost, _inner_jaxprs
    if eqn.primitive.name == "dot_general":
        return _eqn_cost(eqn)[0]
    return sum(_ref_product_flops(j) for j in _inner_jaxprs(eqn.params))


def test_cost_model_prices_the_flash_operators():
    q = torch.randn(8, 16, 32)
    k = torch.randn(4, 16, 32)

    def f(q, k, v):
        return torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, True, 0.2, 2)

    prog, _ = pir.capture(f, q, k, k)
    cost = pir.CostModel().analyze(prog)
    assert cost.flops == 4.0 * 8 * 16 * 16 * 32 * 0.5
    assert cost.per_op[0][0] == "paddle_tpu_torch.flash_fwd.default"
    assert cost.summary()["flops"] == cost.flops


def test_k1_operator_differentiates_through_k3_k4():
    """The registered K1 operator (what a captured program holds on the
    card) has K3/K4 as its backward: the same gradients as the eager
    autograd Function, here through their plain versions."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, 16, 32, generator=g, requires_grad=True)
               for s in (8, 4, 4))
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, True, 0.2, 2)
    assert not lse.requires_grad
    dout = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), dout)
    eager = fa._FlashAttention.apply(q, k, v, True, 0.2, 2)
    assert torch.equal(out, eager)
    want = torch.autograd.grad(eager, (q, k, v), dout)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_effect_scopes_stamp_the_paged_kv_writes():
    from paddle_tpu_torch.ops import paged_attention as pa

    def f(k_cache, v_cache, k_new, v_new, table_row):
        pa.write_chunk_to_cache(k_cache, v_cache, k_new, v_new, table_row, 0)
        with pir.effect_scope("kv.write"):
            k_cache.add_(1.0)
        with pir.effect_scope("kv.rollback"):
            v_cache.mul_(0.5)
        return (k_cache.sum() + v_cache.sum(),)

    args = [torch.zeros(4, 2, 1, 8), torch.zeros(4, 2, 1, 8),
            torch.ones(3, 1, 8), torch.ones(3, 1, 8),
            torch.tensor([1, 2, 0, 3])]
    prog, _ = pir.capture(f, *args)
    eff = [(op.attrs["effect"], op.attrs["effect_seq"]) for op in prog.ops
           if op.attrs.get("effect")]
    assert [e for e, _ in eff] == ["kv.write", "kv.write", "kv.write",
                                   "kv.rollback"]
    assert [s for _, s in eff] == [0, 1, 2, 3]
    pm = pir.PassManager.default()
    for p in pm.passes:
        p.run(prog)
        pir.verify_program(prog, strict_dead=(p.name == "dce"), where=p.name)
    assert len([op for op in prog.ops if op.attrs.get("effect")]) == 4
    fresh = [a.clone() for a in args]
    assert torch.equal(prog.bind(*fresh)[0], f(*[a.clone() for a in args])[0])
