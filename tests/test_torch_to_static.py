"""The port's jit.to_static (paddle_tpu_torch/jit/__init__.py) and its
graph-break segments (framework/staging.py) on the CPU, held to the
reference's tests/test_to_static.py cases: each function runs through the
reference's to_static and the port's on the same inputs, and the staged
ones must give the same values, the same segment counts and the same
gradients as eager.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch import jit, pir, static
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.framework import flags as _flags
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)   # float32 against the reference


def _mlp():
    pt.seed(0)
    return pt.nn.Sequential(pt.nn.Linear(8, 16, device="cpu"), pt.nn.ReLU(),
                            pt.nn.Linear(16, 4, device="cpu"))


def _x(seed, *shape):
    return torch.tensor(np.random.RandomState(seed).randn(*shape),
                        dtype=torch.float32)


def _quiet(sf, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return sf(*args)


def _ref_staged(fn, x):
    """The reference's to_static of `fn` on x (a numpy array)."""
    sf = paddle.jit.to_static(fn)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = sf(paddle.Tensor(jnp.asarray(x)))
    return float(np.asarray(out._data)), sf._last_segments


def test_to_static_matches_eager_bit_for_bit():
    model = _mlp()
    x = _x(0, 4, 8)
    with torch.no_grad():
        eager = model(x)
        out = jit.to_static(model)(x)     # a Layer: forward replaced
    assert isinstance(model.forward, jit.StaticFunction)
    assert torch.equal(out, eager)
    assert model.forward.last_report.fallback is None


def test_to_static_backward_matches_eager():
    model = _mlp()
    x = _x(1, 4, 8)
    model(x).mean().backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    jit.to_static(model.forward)(x).mean().backward()
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=1e-6, atol=1e-7,
                                   msg=k)


def test_signature_cache_reuse_shapes_and_lru(monkeypatch):
    model = _mlp()
    sf = jit.to_static(model.forward)
    obs.get_registry().reset()
    obs.enable()
    try:
        sf(torch.ones(4, 8))
        sf(torch.ones(4, 8))
        assert len(sf._cache) == 1            # same signature: reused
        sf(torch.ones(2, 8))
        assert len(sf._cache) == 2            # new shape: new program
        assert obs.get_registry().get("jit_retrace_total").value == 2
        prev = _flags.flag_value("jit_signature_cache_size")
        _flags.set_flags({"jit_signature_cache_size": 2})
        try:
            sf(torch.ones(3, 8))
            assert len(sf._cache) == 2        # the coldest evicted
        finally:
            _flags.set_flags({"jit_signature_cache_size": prev})
    finally:
        obs.disable()
        obs.get_registry().reset()


def test_graph_break_runs_staged_and_full_graph_raises():
    def fn(x):
        if float(x.sum()) > 0:
            return x * 2
        return x - 1

    sf = jit.to_static(fn)
    with pytest.warns(RuntimeWarning, match="graph break"):
        out = sf(torch.ones(3))
    assert torch.equal(out, 2 * torch.ones(3))
    out2 = sf(-torch.ones(3))                 # same signature: staged
    assert torch.equal(out2, -2 * torch.ones(3))
    with pytest.raises(pir.GraphBreak):
        jit.to_static(fn, full_graph=True)(torch.ones(3))


def test_enable_to_static_and_not_to_static():
    model = _mlp()
    sf = jit.to_static(model.forward)
    jit.enable_to_static(False)
    try:
        assert tuple(sf(torch.ones(2, 8)).shape) == (2, 4)
        assert len(sf._cache) == 0
    finally:
        jit.enable_to_static(True)
    plain = jit.not_to_static(lambda x: x + 1)
    sf2 = jit.to_static(plain)
    assert torch.equal(sf2(torch.ones(2)), torch.full((2,), 2.0))
    assert len(sf2._cache) == 0


def _prefix_fn(lib):
    def fn(x):
        a = x * 2.0
        b = a + 1.0
        c = b.sum()
        if float(c) > 0:
            return (b * 3.0).sum()
        return (b / 2.0).sum()
    return fn


def test_staged_segments_and_their_cache_match_the_reference():
    sf = jit.to_static(_prefix_fn(torch))
    x = np.ones(4, np.float32)
    with pytest.warns(RuntimeWarning, match="staged segments"):
        out = sf(torch.tensor(x))
    want, ref_segments = _ref_staged(_prefix_fn(paddle), x)
    assert float(out) == want == (1 * 2 + 1) * 3 * 4
    assert sf._last_segments == ref_segments == 2
    assert len(sf._staged_jit_cache) == 2
    out2 = sf(torch.full((4,), 2.0))          # the same two segments
    assert float(out2) == (2 * 2 + 1) * 3 * 4
    assert sf._last_segments == 2 and len(sf._staged_jit_cache) == 2


def test_other_branch_matches_the_reference():
    x = np.full((4,), -3.0, np.float32)
    got = _quiet(jit.to_static(_prefix_fn(torch)), torch.tensor(x))
    want, _ = _ref_staged(_prefix_fn(paddle), x)
    np.testing.assert_allclose(float(got), want, **TOL)
    assert float(got) == float(_prefix_fn(torch)(torch.tensor(x)))


def test_multiple_breaks_match_the_reference():
    def fn(x):
        a = x + 1.0
        if float(a.sum()) > 0:
            b = a * 2.0
        else:
            b = a * 4.0
        if float(b.max()) > 100.0:
            return b.sum()
        return (b + 0.5).sum()

    sf = jit.to_static(fn)
    x = np.ones(3, np.float32)
    got = _quiet(sf, torch.tensor(x))
    want, ref_segments = _ref_staged(fn, x)
    assert float(got) == want == 13.5
    assert sf._last_segments == ref_segments == 3


def test_backward_through_a_break_matches_eager():
    def fn(x):
        a = torch.tanh(x) * 2.0
        if float(a.sum()) > -1e9:
            return (a * a).sum()
        return a.sum()

    x1 = torch.linspace(-1, 1, 6).requires_grad_()
    x2 = torch.linspace(-1, 1, 6).requires_grad_()
    sf = jit.to_static(fn)
    _quiet(sf, x1).backward()
    fn(x2).backward()
    assert sf._last_segments == 2
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-6, atol=0)


def test_backward_through_a_boolean_index_matches_eager():
    """A data-dependent op (a boolean index) is a break taken above
    autograd: its gradient reaches x and w as in eager."""
    def fn(x, w):
        a = torch.tanh(x) * w
        return (a[a > 0] ** 2).sum() + a.sum()

    got = [_x(3, 12).requires_grad_(), _x(4, 12).requires_grad_()]
    want = [t.detach().clone().requires_grad_() for t in got]
    sf = jit.to_static(fn)
    out = _quiet(sf, *got)
    out.backward()
    fn(*want).backward()
    assert sf._last_segments == 2
    torch.testing.assert_close(out, fn(*want), rtol=1e-6, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.grad, w.grad, rtol=1e-6, atol=0)


def test_scalar_types_are_not_conflated():
    def fn(x, flag):
        y = x * (2.0 if flag else 0.5)
        if float(y.sum()) != 0:
            return y.sum() + (1 if isinstance(flag, bool) else 0)
        return y.sum()

    sf = jit.to_static(fn)
    x = torch.ones(2)
    a = float(_quiet(sf, x, True))
    b = float(_quiet(sf, x, 1))
    assert (a, b) == (5.0, 4.0)


def test_static_program_prints_the_captured_ir():
    model = _mlp()
    jit.to_static(model.forward)(torch.ones(2, 8))
    text = str(static.default_main_program())
    assert text.startswith("program @forward") and "aten.mm.default" in text
    assert static.CompiledProgram(static.default_main_program()) \
        .to_string() == text
    assert "no captured IR" in str(static.Program())


def test_llama_tiny_logits_loss_and_grads_through_to_static():
    pt.seed(0)
    model = pt.models.llama_tiny(device="cpu", num_hidden_layers=2)
    ids = torch.tensor(np.random.RandomState(0).randint(0, 512, (2, 16)))
    loss_e, logits_e = model(ids, labels=ids)
    loss_e.backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    sf = jit.to_static(model.forward)
    loss, logits = sf(ids, labels=ids)
    assert sf.last_report.pattern_counts == {"sdpa_route": 2}
    assert torch.equal(logits, logits_e) and torch.equal(loss, loss_e)
    loss.backward()
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
