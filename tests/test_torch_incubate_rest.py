"""The rest of the port's incubate against the JAX package's, on the CPU in
float32, inputs drawn by numpy from a seed: ASP (create_mask on every
weight rank, the checks, prune_model and decorate on bert_tiny with masks
equal to the reference's), the MoE layer and its three gates
(chip_smoke.py's phase-23 block at a small size, weights through
convert.py), the segment and graph ops, the fused softmaxes, LookAhead,
ModelAverage and autotune (set_config round trips, the tuner's choice,
the flash wrapper's one-tile candidate list).

Tolerances: float32 rtol 1e-5, atol 1e-6 for elementwise results and
reductions in one order; 1e-5/1e-5 for products (the MoE block). Masks,
reindexed graphs and deterministic samples are equal exactly; random
draws are held to their support and contract.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.incubate import asp
from paddle_tpu_torch.ops import autotune as tuner
from paddle_tpu_torch.ops import flash_attention as fa
from torch_seq_parity import copy_weights, ref_np, reference

EXACT = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)

_R = np.random.RandomState(0)
JASP = paddle.incubate.asp


@pytest.fixture
def on_cpu():
    prev = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


def _t(a):
    return torch.tensor(a)


def _r(a):
    return paddle.to_tensor(a)


# -- ASP ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(10,), (8, 12), (8, 6), (3, 4, 8),
                                   (4, 6, 3, 3)],
                         ids=["1d", "2d", "2d-padded", "3d", "4d"])
@pytest.mark.parametrize("nm", [(2, 4), (1, 4)])
def test_create_mask_matches_reference(shape, nm):
    w = _R.randn(*shape).astype(np.float32)
    want = JASP.create_mask(w, n=nm[0], m=nm[1])
    got = asp.create_mask(_t(w), n=nm[0], m=nm[1])
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(asp.create_mask(w, n=nm[0], m=nm[1]),
                                  want)
    assert asp.check_sparsity(got * _t(w), nm[0], nm[1]) == \
        JASP.check_sparsity(want * w, nm[0], nm[1]) is True


def test_mask_of_bf16_is_built_in_float32():
    w = _R.randn(16, 8).astype(np.float32)
    got = asp.create_mask(_t(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = asp.create_mask(_t(w).to(torch.bfloat16).float())
    np.testing.assert_array_equal(got.float().numpy(), want.numpy())


def test_mask_ties_drop_the_lower_index():
    """A group of equal |w|: the stable sort drops the first m - n."""
    got = asp.create_mask(_t(np.array([[1.0, -1.0, 1.0, 1.0]],
                                      np.float32)))
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 1, 1]])


def test_checks_and_density():
    a = np.array([[1, 0, 2, 0, 0, 3, 0, 4], [1, 1, 1, 0, 0, 0, 0, 0]],
                 np.float32)
    for f in ("check_mask_1d", "check_mask_2d", "check_sparsity"):
        assert getattr(asp, f)(_t(a)) == getattr(JASP, f)(a)
        assert getattr(asp, f)(_t(a[:1])) == getattr(JASP, f)(a[:1])
    assert asp.check_mask_1d(_t(a[0, :6])) == JASP.check_mask_1d(a[0, :6])
    assert asp.calculate_density(_t(a)) == JASP.calculate_density(a)


def _masked(model):
    return {n: p._asp_mask for n, p in model.named_parameters()
            if getattr(p, "_asp_mask", None) is not None}


def test_prune_bert_tiny_matches_reference(on_cpu):
    """prune_model(n=2, m=4) on bert_tiny with the reference's weights:
    the same layers pruned with the same masks and densities; the
    excluded head and the embeddings and norms carry no mask; the
    decorated optimizer keeps every mask through a step."""
    make = lambda P: P.models.bert_tiny(dropout=0.0)   # noqa: E731
    ref = reference(lambda: make(paddle))
    port = copy_weights(make(pt), ref)
    try:
        JASP.set_excluded_layers(["nsp_head"])
        asp.set_excluded_layers(["nsp_head"])
        want = JASP.prune_model(ref, n=2, m=4)
        got = asp.prune_model(port, n=2, m=4)
    finally:
        JASP.reset_excluded_layers()
        asp.reset_excluded_layers()
    assert got.keys() == want.keys() and len(got) == 2 * 6 + 2
    for k in got:
        assert got[k] == pytest.approx(want[k]) == pytest.approx(0.5)
    masks = _masked(port)
    ref_params = dict(ref.named_parameters())
    assert set(masks) == {k + ".weight" for k in got}
    for name, mask in masks.items():
        np.testing.assert_array_equal(
            mask.numpy(), np.asarray(ref_params[name]._asp_mask))
    for name, p in port.named_parameters():
        if "embeddings" in name or "norm" in name or "nsp_head" in name:
            assert not hasattr(p, "_asp_mask"), name
    opt = asp.decorate(pt.optimizer.AdamW(1e-2,
                                          parameters=port.parameters()))
    ids = _t(_R.randint(0, 512, (2, 16)))
    loss = port(ids, masked_lm_labels=ids)[0]
    loss.backward()
    opt.step()
    opt.clear_grad()
    for name, p in port.named_parameters():
        if name in masks:
            assert asp.check_sparsity(p.detach())
            assert (p.detach()[masks[name] == 0] == 0).all()
            assert asp.calculate_density(p) == pytest.approx(0.5)


def test_decorate_step_matches_reference(on_cpu):
    """A pruned two-layer net, one decorated SGD step, equal weights."""
    make = lambda P: P.nn.Sequential(P.nn.Linear(16, 32), P.nn.ReLU(),  # noqa
                                     P.nn.Linear(32, 8))
    ref = reference(lambda: make(paddle))
    port = copy_weights(make(pt), ref)
    JASP.prune_model(ref)
    asp.prune_model(port)
    x = _R.randn(4, 16).astype(np.float32)
    ropt = JASP.decorate(paddle.optimizer.SGD(
        0.1, parameters=ref.parameters()))
    popt = asp.decorate(pt.optimizer.SGD(0.1,
                                         parameters=port.parameters()))
    ref(_r(x)).square().mean().backward()
    ropt.step()
    port(_t(x)).square().mean().backward()
    popt.step()
    for (n, p), (_, q) in zip(port.named_parameters(),
                              ref.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), ref_np(q), **TOL,
                                   err_msg=n)
    # a Linear as the model itself is pruned under "<root>"
    lin = pt.nn.Linear(16, 8)
    assert list(asp.prune_model(lin)) == ["<root>"]


# -- MoE ---------------------------------------------------------------------

def _moe_pair(top_k=2):
    build = lambda P: cs.moe_block(P, 16, 24, 4, top_k)   # noqa: E731
    ref = reference(lambda: build(paddle))
    np_state = {k: ref_np(v) for k, v in ref.state_dict().items()}
    port = build(pt)
    port.set_state_dict(convert.state_from_reference(np_state, "cpu"))
    return port, ref


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer_and_gshard_loss(top_k, on_cpu):
    port, ref = _moe_pair(top_k)
    assert list(port.state_dict()) == list(ref.state_dict())
    x = _R.randn(2, 6, 16).astype(np.float32)
    got, want = port(_t(x)), ref(_r(x))
    assert tuple(got.shape) == (2, 6, 16)
    np.testing.assert_allclose(got.detach().numpy(), ref_np(want), **TOL)
    np.testing.assert_allclose(float(port.gate.loss),
                               float(ref_np(ref.gate.loss)), **TOL)
    got.sum().backward()
    assert all(p.grad is not None for p in port.parameters())


def test_moe_default_gate_and_dict_gate(on_cpu):
    moe = pt.incubate.distributed.models.moe
    experts = [cs.swiglu_expert(pt, 8, 12) for _ in range(3)]
    layer = moe.MoELayer(8, experts, gate={"type": "naive", "top_k": 1})
    assert isinstance(layer.gate, moe.NaiveGate) and layer.top_k == 1
    assert layer.gate.gate.weight.dtype == torch.float32
    out = layer(torch.randn(5, 8))
    assert out.shape == (5, 8)


@pytest.mark.parametrize("cls", ["NaiveGate", "GShardGate", "SwitchGate"])
def test_gates_through_convert(cls, on_cpu):
    jm = paddle.incubate.distributed.models.moe
    ref = reference(lambda: getattr(jm, cls)(8, 4))
    np_state = {k: ref_np(v) for k, v in ref.state_dict().items()}
    port = getattr(pt.incubate.distributed.models.moe, cls)(8, 4)
    port.set_state_dict(convert.state_from_reference(np_state, "cpu"))
    ref.eval()
    port.eval()
    x = _R.randn(5, 8).astype(np.float32)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               ref_np(ref(_r(x))), **TOL)


def test_switch_gate_noise(on_cpu):
    """In training the logits get U(1 - eps, 1 + eps) added: the softmax
    of the noisy logits, each draw within that band of the clean one."""
    gate = pt.incubate.distributed.models.moe.SwitchGate(8, 4,
                                                         switch_eps=0.1)
    assert gate.top_k == 1
    x = torch.randn(64, 8)
    pt.seed(0)
    a = gate(x)
    pt.seed(0)
    b = gate(x)
    torch.testing.assert_close(a, b)
    noise = torch.log(a) - torch.log_softmax(gate.gate(x), -1)
    noise = noise - noise[:, :1]                # up to a row constant
    assert noise.abs().max() <= 0.2 + 1e-5 and noise.abs().max() > 0
    gate.eval()
    torch.testing.assert_close(gate(x), torch.softmax(gate.gate(x), -1))


def test_moe_convert_raises_on_a_missing_expert(on_cpu):
    _, ref = _moe_pair()
    np_state = {k: ref_np(v) for k, v in ref.state_dict().items()
                if not k.startswith("experts.3.")}
    with pytest.raises(KeyError, match="experts.3"):
        convert.state_from_reference(np_state, "cpu")


# -- segment, graph and softmax ops -------------------------------------------

X = _R.randn(7, 3).astype(np.float32)
IDS = np.array([0, 0, 2, 2, 2, 4, 4])              # segments 1 and 3 empty


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "min"])
def test_incubate_segments(pool):
    got = getattr(pt.incubate, f"segment_{pool}")(_t(X), _t(IDS))
    want = getattr(paddle.incubate, f"segment_{pool}")(_r(X), _r(IDS))
    np.testing.assert_allclose(got.numpy(), ref_np(want), **EXACT)
    if pool in ("max", "min"):
        assert torch.isinf(got[1]).all()       # jax.ops' identity


def test_graph_ops():
    src, dst = np.array([0, 1, 2, 3, 4]), np.array([1, 2, 0, 0, 3])
    for pool in ("sum", "mean", "max", "min"):
        np.testing.assert_allclose(
            pt.incubate.graph_send_recv(_t(X), _t(src), _t(dst), pool,
                                        7).numpy(),
            ref_np(paddle.incubate.graph_send_recv(_r(X), _r(src), _r(dst),
                                                   pool, 7)), **EXACT)
    x, nbrs = np.array([5, 9, 2]), np.array([9, 7, 7, 3, 5, 11, 2])
    cnt = np.array([2, 4, 1])
    for g, w in zip(pt.incubate.graph_reindex(_t(x), _t(nbrs), _t(cnt)),
                    paddle.incubate.graph_reindex(_r(x), _r(nbrs),
                                                  _r(cnt))):
        np.testing.assert_array_equal(g.numpy(), ref_np(w))
    row = np.array([1, 2, 3, 4, 0, 2, 5, 0, 1, 3, 4, 5])
    colptr = np.array([0, 4, 7, 7, 10, 12, 12])
    nodes = np.array([0, 1, 3, 4])
    for g, w in zip(
            pt.incubate.graph_sample_neighbors(_t(row), _t(colptr),
                                               _t(nodes)),
            paddle.incubate.graph_sample_neighbors(_r(row), _r(colptr),
                                                   _r(nodes))):
        np.testing.assert_array_equal(g.numpy(), ref_np(w))
    pt.seed(1)
    nb, ct = pt.incubate.graph_sample_neighbors(_t(row), _t(colptr),
                                                _t(nodes), sample_size=2)
    assert ct.tolist() == [2, 2, 2, 2] and nb.dtype == torch.int64
    at = 0
    for v, c in zip(nodes, ct.tolist()):
        picks = nb[at:at + c].tolist()
        assert len(set(picks)) == c and set(picks) <= set(
            row[colptr[v]:colptr[v + 1]])
        at += c
    got = pt.incubate.graph_khop_sampler(_t(row), _t(colptr), _t(nodes[:2]),
                                         [-1, -1])
    want = paddle.incubate.graph_khop_sampler(_r(row), _r(colptr),
                                              _r(nodes[:2]), [-1, -1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), ref_np(w))


def test_identity_loss_and_fused_softmax():
    for red in ("none", "sum", "mean", 0, 1):
        np.testing.assert_allclose(
            pt.incubate.identity_loss(_t(X), red).numpy(),
            ref_np(paddle.incubate.identity_loss(_r(X), red)), **EXACT)
    a = _R.randn(2, 3, 5, 5).astype(np.float32)
    mask = np.where(_R.rand(2, 1, 5, 5) > 0.3, 0.0, -1e4).astype(np.float32)
    np.testing.assert_allclose(
        pt.incubate.softmax_mask_fuse(_t(a), _t(mask)).numpy(),
        ref_np(paddle.incubate.softmax_mask_fuse(_r(a), _r(mask))), **EXACT)
    got = pt.incubate.softmax_mask_fuse_upper_triangle(_t(a))
    np.testing.assert_allclose(
        got.numpy(),
        ref_np(paddle.incubate.softmax_mask_fuse_upper_triangle(_r(a))),
        **EXACT)
    assert (got[..., 0, 1:] == 0).all()
    # a bf16 input comes out in float32, as the reference's does
    half = pt.incubate.softmax_mask_fuse_upper_triangle(
        _t(a).to(torch.bfloat16))
    assert half.dtype == torch.float32


def _sgd_pair(lr=0.1):
    w0 = _R.randn(6).astype(np.float32)
    pw = torch.nn.Parameter(_t(w0.copy()))
    rw = paddle.create_parameter([6], "float32")
    rw.set_value(w0.copy())
    return (pw, pt.optimizer.SGD(lr, parameters=[pw])), \
        (rw, paddle.optimizer.SGD(lr, parameters=[rw]))


def test_lookahead_matches_reference():
    (pw, popt), (rw, ropt) = _sgd_pair()
    pla = pt.incubate.LookAhead(popt, alpha=0.4, k=3)
    rla = paddle.incubate.LookAhead(ropt, alpha=0.4, k=3)
    target = _R.randn(6).astype(np.float32)
    for _ in range(7):
        ((pw - _t(target)) ** 2).sum().backward()
        pla.step()
        pla.clear_grad()
        ((rw - _r(target)) ** 2).sum().backward()
        rla.step()
        rla.clear_grad()
        np.testing.assert_allclose(pw.detach().numpy(), ref_np(rw), **EXACT)


def test_model_average_matches_reference():
    (pw, popt), (rw, ropt) = _sgd_pair()
    pma = pt.incubate.ModelAverage(0.15, parameters=[pw])
    rma = paddle.incubate.ModelAverage(0.15, parameters=[rw])
    target = _R.randn(6).astype(np.float32)
    for _ in range(4):
        ((pw - _t(target)) ** 2).sum().backward()
        popt.step()
        popt.clear_grad()
        pma.step()
        ((rw - _r(target)) ** 2).sum().backward()
        ropt.step()
        ropt.clear_grad()
        rma.step()
    before = pw.detach().clone()
    with pma.apply(), rma.apply():
        np.testing.assert_allclose(pw.detach().numpy(), ref_np(rw), **EXACT)
        assert not torch.equal(pw.detach(), before)
    torch.testing.assert_close(pw.detach(), before, rtol=0, atol=0)
    with pma.apply(need_restore=False):
        pass
    pma.restore()
    torch.testing.assert_close(pw.detach(), before, rtol=0, atol=0)


# -- autotune ----------------------------------------------------------------

@pytest.fixture
def tuning_state():
    saved = pt.incubate.autotune.get_config()
    yield
    pt.incubate.autotune._config = saved
    tuner.disable_autotune()
    tuner.clear_cache()


def test_set_config_round_trips(tmp_path, tuning_state):
    at = pt.incubate.autotune
    at.set_config({"kernel": {"enable": True, "tuning_range": [1, 3]}})
    assert tuner.autotune_enabled() and at.status()["enabled"]
    assert at.get_config()["kernel"] == {"enable": True,
                                         "tuning_range": [1, 3]}
    at.set_config({"layout": {"enable": True}})      # kernel switch kept
    assert tuner.autotune_enabled()
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"kernel": {"enable": False},
                                "dataloader": {"enable": True}}))
    at.set_config(str(path))
    assert not tuner.autotune_enabled()
    assert at.get_config()["dataloader"]["enable"]
    at.set_config(None)
    assert all(v["enable"] for v in at.get_config().values())
    with pytest.raises(ValueError, match="unknown autotune section"):
        at.set_config({"bogus": {}})
    with pytest.raises(TypeError):
        at.set_config(3)
    ref = paddle.incubate.autotune
    assert set(at.get_config()) == set(ref.get_config())


def test_autotune_picks_the_fastest_and_caches(tuning_state):
    import time
    ran = []

    def make_runner(c):
        if c == "broken":
            raise RuntimeError("does not compile")
        return lambda: (ran.append(c), time.sleep(0.002 * c))
    assert tuner.autotune("k", [3, "broken", 1, 2], make_runner) == 3
    tuner.enable_autotune()
    assert tuner.autotune("k", [3, "broken", 1, 2], make_runner) == 1
    assert set(tuner.timing_log["k"]) == {"3", "1", "2"}
    n = len(ran)
    assert tuner.autotune("k", [3, 1, 2], make_runner) == 1 and \
        len(ran) == n
    assert tuner.autotune_status()["cache_hits"] == 1


def test_flash_tile_candidates_tune_to_the_compiled_tile(tuning_state):
    """The kernels are compiled for one tile, so the tuner, on or off,
    returns it; with tuning on its runner is timed once per key, then
    cached."""
    assert fa.TILE_CANDIDATES == ((128, 128),)
    calls = []

    def make_runner(tile):
        return lambda: calls.append(tile)
    assert tuner.autotune("fwd", fa.TILE_CANDIDATES, make_runner) == \
        (128, 128)
    assert not calls                      # tuning off: no run
    tuner.enable_autotune()
    assert tuner.autotune("fwd", fa.TILE_CANDIDATES, make_runner) == \
        (128, 128)
    assert len(calls) == 3                # a warm-up and two timed runs
    tuner.autotune("fwd", fa.TILE_CANDIDATES, make_runner)
    assert len(calls) == 3
