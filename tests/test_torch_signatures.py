"""Reference-style calls bind the same way in the port.

Every name in an `__all__` of the port that the JAX package's module of the
same path also exports is held to the reference's signature: the
reference's positional parameters, less a trailing `name`, must start the
port's positional list in the same order, and every parameter the
reference names must be one the port accepts. Port-only parameters
(`dtype`, `device`) come after them, keyword-only.

Left out of the walk:
- records whose first field is `name` (_NAME_RECORDS): dataclass-style
  records whose fields are their own API, checked by their modules' tests;
- the port's `tools` (the reference has no such package).
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt

_NAME_RECORDS = {"LoraWeights", "Scenario", "Tensor", "SLOSpec", "Series",
                 "Span", "KVBlockFormat", "ProgramCost", "RecordEvent"}


def _port_modules():
    names = ["paddle_tpu_torch"]
    for m in pkgutil.walk_packages(pt.__path__, "paddle_tpu_torch."):
        if ".tools" not in m.name and "._build" not in m.name:
            names.append(m.name)
    return names


def _pairs():
    """(port module, name, reference module) for every shared public name."""
    out = []
    for mod in _port_modules():
        port = importlib.import_module(mod)
        try:
            ref = importlib.import_module(
                "paddle_tpu" + mod[len("paddle_tpu_torch"):])
        except ModuleNotFoundError:
            continue
        for name in getattr(port, "__all__", ()):
            if name in _NAME_RECORDS or not hasattr(ref, name):
                continue
            if callable(getattr(port, name)) and callable(getattr(ref, name)):
                out.append((mod, name, ref.__name__))
    return out


_PAIRS = _pairs()


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):     # a builtin __init__ (exceptions)
        return None


def _positional(sig):
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_the_walk_covers_the_ported_surface():
    names = {n for _, n, _ in _PAIRS}
    for n in ("flash_attention", "Conv2D", "Embedding", "RMSNorm",
              "cross_entropy", "AdamW", "LayerList", "XavierUniform",
              "LlamaConfig", "seed", "fused_rotary_position_embedding",
              "weight_quantize", "QAT", "FusedMultiTransformer",
              "block_multihead_attention", "WeightOnlyGenerator",
              # the graph, sparsity, MoE and distribution slice
              "sparse_coo_tensor", "masked_matmul", "SubmConv3D",
              "send_u_recv", "sample_neighbors", "prune_model", "decorate",
              "MoELayer", "GShardGate", "set_config",
              "LookAhead", "graph_khop_sampler", "MultivariateNormal",
              "kl_divergence", "StickBreakingTransform"):
        assert n in names, n
    assert len(_PAIRS) > 400


@pytest.mark.parametrize("mod,name,ref_mod", _PAIRS,
                         ids=[f"{m}.{n}" for m, n, _ in _PAIRS])
def test_reference_calls_bind_in_the_port(mod, name, ref_mod):
    port = getattr(importlib.import_module(mod), name)
    ref = getattr(importlib.import_module(ref_mod), name)
    ps, rs = _signature(port), _signature(ref)
    if rs is None:
        # both built-in: an exception class's constructor
        assert ps is None, f"{name}: the port's {ps} against a builtin"
        return
    assert ps is not None, name
    ref_pos = _positional(rs)
    if ref_pos and ref_pos[-1] == "name":
        ref_pos = ref_pos[:-1]
    port_pos = _positional(ps)
    assert port_pos[:len(ref_pos)] == ref_pos, (
        f"{mod}.{name}: reference positionals {ref_pos}, port {port_pos}")
    params = ps.parameters.values()
    if not any(p.kind == p.VAR_KEYWORD for p in params):
        ref_kw = [p.name for p in rs.parameters.values()
                  if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
        missing = [k for k in ref_kw if k not in ps.parameters]
        assert not missing, f"{mod}.{name} rejects {missing}"
    extra = [p.name for p in params
             if p.kind == p.POSITIONAL_OR_KEYWORD
             and p.name not in rs.parameters and p.name in ("dtype",
                                                             "device")]
    assert not extra, f"{mod}.{name}: port-only {extra} must be keyword-only"


def test_name_records_are_records_named_first():
    """The skip list holds exactly such records."""
    import paddle_tpu.inference as ji
    import paddle_tpu.observability as jo
    import paddle_tpu.observability.tracing as jt
    import paddle_tpu.ops.paged_attention as jp
    import paddle_tpu.pir.analysis as ja
    import paddle_tpu.profiler as jpr
    found = {"LoraWeights": ji, "Scenario": ji, "Tensor": ji, "SLOSpec": jo,
             "Series": jo, "Span": jt, "KVBlockFormat": jp,
             "ProgramCost": ja, "RecordEvent": jpr}
    assert set(found) == _NAME_RECORDS
    for n, m in found.items():
        assert _positional(inspect.signature(getattr(m, n)))[0] == "name", n


# -- the calls Queue 3 of the roadmap named, each bound as the reference --

def _qkv(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(2, 16, 2, 8, generator=g) for _ in range(3)]


def test_flash_attention_sixth_positional_is_return_softmax():
    """flash_attention(q, k, v, 0.5, False, False): dropout 0.5 in training
    (the reference's default), return_softmax False. The port once read
    the sixth positional as `training` and applied no dropout."""
    q, k, v = _qkv()
    plain, _ = pt.nn.functional.flash_attention(q, k, v, 0.0, False)
    pt.seed(0)
    out, soft = pt.nn.functional.flash_attention(q, k, v, 0.5, False, False)
    assert soft is None
    assert not torch.allclose(out, plain)
    # training=False by keyword: no dropout
    out, _ = pt.nn.functional.flash_attention(q, k, v, 0.5, False, False,
                                              training=False)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_flash_attention_return_softmax_gives_none():
    q, k, v = _qkv(1)
    out, soft = pt.nn.functional.flash_attention(q, k, v, 0.0, True, True,
                                                 None, True, "attn",
                                                 rng_name="x")
    assert soft is None
    want = pt.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_layers_bind_reference_positionals():
    nn = pt.nn
    conv = nn.Conv2D(3, 4, 3, 1, 0, 1, 1, "zeros", None, False, "NCHW",
                     device="cpu")
    assert conv.bias is None and tuple(conv.weight.shape) == (4, 3, 3, 3)
    emb = nn.Embedding(10, 4, 0, True, None, "emb", device="cpu")
    assert torch.all(emb.weight[0] == 0)
    norm = nn.RMSNorm(8, 1e-5, nn.initializer.Constant(2.0), "n",
                      device="cpu")
    assert torch.all(norm.weight == 2.0) and norm.epsilon == 1e-5
    lin = nn.Linear(4, 2, None, False, "fc", device="cpu")
    assert lin.bias is None
    ll = nn.LayerList(sublayers=[lin, norm])
    assert len(ll) == 2 and ll[0] is lin
    x = torch.arange(6).reshape(2, 3)
    torch.testing.assert_close(
        nn.functional.embedding(x=x, weight=emb.weight, padding_idx=0,
                                sparse=True, name="e"), emb.weight[x])


def test_xavier_uniform_takes_fans_and_gain():
    from paddle_tpu_torch.nn.initializer import XavierUniform
    g = torch.Generator().manual_seed(0)
    w = XavierUniform(100, 50, 0.5)((400, 400), torch.float32, "cpu", g)
    limit = 0.5 * (6.0 / 150) ** 0.5
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit


def test_unported_values_raise():
    nn, F = pt.nn, pt.nn.functional
    with pytest.raises(NotImplementedError):
        nn.Conv1D(2, 2, 3, padding_mode="reflect", device="cpu")
    logits, label = torch.randn(4, 5), torch.tensor([0, 1, 2, 3])
    # use_softmax=False (ported since) by position: input holds
    # probabilities; use_softmax=True lands on use_softmax, not smoothing
    torch.testing.assert_close(
        F.cross_entropy(logits.softmax(-1), label, None, -100, "mean",
                        False, -1, False),
        F.cross_entropy(logits, label))
    torch.testing.assert_close(
        F.cross_entropy(logits, label, None, -100, "mean", False, -1, True),
        F.cross_entropy(logits, label))
    # AdamW's lr_ratio and apply_decay_param_fun (accepted since, and
    # ignored as the reference ignores them) bind by position and name
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt = pt.optimizer.AdamW(0.1, 0.9, 0.999, 1e-8, p, 0.01, 0.5)
    assert opt._apply_decay_fn is None
    f = lambda n: True   # noqa: E731
    opt = pt.optimizer.AdamW(0.1, parameters=p, apply_decay_param_fun=f)
    assert opt._apply_decay_fn is f
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_rms_norm, fused_rotary_position_embedding)
    q = torch.randn(1, 4, 2, 8)
    with pytest.raises(NotImplementedError):
        fused_rotary_position_embedding(q, time_major=True)
    with pytest.raises(NotImplementedError):
        fused_rms_norm(q, quant_scale=1.0)


def test_reference_ignored_arguments_are_accepted():
    p = [torch.nn.Parameter(torch.ones(2))]
    opt = pt.optimizer.Adam(0.1, 0.9, 0.999, 1e-8, p, None, None, True,
                            True, True, "adam", False)
    p[0].grad = torch.ones(2)
    opt.step()
    assert float(p[0][0]) < 1.0
    cfg = pt.models.LlamaConfig(use_flash_attention=False)
    assert cfg.use_flash_attention is False
    pt.seed(s=3)
    a = torch.rand(2, generator=pt.framework.get_generator("cpu"))
    pt.seed(3)
    b = torch.rand(2, generator=pt.framework.get_generator("cpu"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("explicit", [False, True])
def test_rotary_sin_cos_and_interleaved_match_reference(neox, explicit):
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import functional as JIF
    from paddle_tpu_torch.incubate.nn import functional as PIF
    rs = np.random.RandomState(3)
    q, k = rs.randn(2, 6, 4, 8).astype(np.float32), \
        rs.randn(2, 6, 2, 8).astype(np.float32)
    pos = rs.randint(0, 6, (2, 6))
    sin = cos = None
    if explicit:
        ang = rs.rand(1, 1, 6, 8).astype(np.float32) * 3
        sin, cos = np.sin(ang), np.cos(ang)
    J = lambda a: None if a is None else paddle.Tensor(jnp.asarray(a))
    want = JIF.fused_rotary_position_embedding(
        J(q), J(k), None, J(sin), J(cos), J(pos.astype(np.int32)), neox)
    T = lambda a: None if a is None else torch.as_tensor(a)
    got = PIF.fused_rotary_position_embedding(
        T(q), T(k), None, T(sin), T(cos), T(pos), neox)
    assert got[2] is None and want[2] is None
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                   rtol=1e-5, atol=1e-5)
