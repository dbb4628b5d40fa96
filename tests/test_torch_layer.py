"""The port's nn.Layer (nn/layer/layers.py) against the reference's
(paddle_tpu/nn/layer/layers.py): the same user model written in both
packages gives the same names, state (a tied weight once), hooks and
outputs; LayerDict and ParameterList; every port layer is a Layer whose
parameters() is a list; a Layer model goes through functional_call and
jit.save/load. Outputs are float32, held at rtol 1e-6, atol 1e-6."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch import jit
from paddle_tpu_torch.parallel.functional import functional_call
from torch_seq_parity import copy_weights, ref_np
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _net(nn, **dd):
    """A user model: a tied pair of Linears, a ParameterList, a LayerDict,
    a parameter from create_parameter, persistable and non-persistable
    buffers."""

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(4, 4, **dd)
            self.b = nn.Linear(4, 4, **dd)
            self.b.weight = self.a.weight          # tied
            self.heads = nn.LayerDict({"x": nn.Linear(4, 3, **dd),
                                       "y": nn.Linear(4, 3, **dd)})
            self.plist = nn.ParameterList([self.create_parameter([3], **dd)])
            self.scale = self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(2.0), **dd)
            self.register_buffer("steps", _zeros(dd))
            self.register_buffer("tmp", _zeros(dd), persistable=False)

        def forward(self, x):
            h = self.b(self.a(x))
            return (self.heads["x"](h) + self.heads["y"](h)) * self.scale \
                + self.plist[0]

    return Net()


def _zeros(dd):
    if dd:
        return torch.zeros(2)
    return paddle.zeros([2])


@pytest.fixture(scope="module")
def pair():
    ref = _net(paddle.nn)
    port = copy_weights(_net(pt.nn, device="cpu"), ref)
    return port, ref


def test_names_and_state(pair):
    port, ref = pair
    assert list(port.state_dict()) == list(ref.state_dict())
    assert "b.weight" not in port.state_dict() and "tmp" not in \
        port.state_dict()
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert isinstance(port.parameters(), list)
    assert len(port.parameters()) == len(ref.parameters()) == 9
    assert [n for n, _ in port.named_sublayers()] == \
        [n for n, _ in ref.named_sublayers()]
    assert len(port.sublayers(include_self=True)) == \
        len(ref.sublayers(include_self=True))
    assert [n for n, _ in port.named_buffers()] == \
        [n for n, _ in ref.named_buffers()]
    assert port.full_name() == ref.full_name() == "net"
    assert len(port.children()) == len(ref.children())
    # a shared weight is one parameter in both
    assert port.b.weight is port.a.weight


def test_forward_hooks_and_grads(pair):
    port, ref = pair
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)

    def pre(layer, inputs):
        return (inputs[0] * 2.0,)

    def post(layer, inputs, out):
        return out + 1.0

    outs = []
    for net, t in ((port, torch.tensor(x)), (ref, paddle.to_tensor(x))):
        h1 = net.register_forward_pre_hook(pre)
        h2 = net.register_forward_post_hook(post)
        y = net(t)
        h1.remove()
        h2.remove()
        outs.append((y, net(t)))
    np.testing.assert_allclose(outs[0][0].detach().numpy(),
                               ref_np(outs[1][0]), **TOL)
    np.testing.assert_allclose(outs[0][1].detach().numpy(),
                               ref_np(outs[1][1]), **TOL)
    assert not np.allclose(ref_np(outs[1][0]), ref_np(outs[1][1]))
    outs[0][1].sum().backward()
    outs[1][1].sum().backward()
    gp = port.a.weight.grad.numpy()
    gr = ref_np(ref.a.weight.grad)
    np.testing.assert_allclose(gp, gr, rtol=1e-5, atol=1e-5)
    port.clear_gradients()
    ref.clear_gradients()
    assert all(p.grad is None for p in port.parameters())


def test_modes_dtype_and_set_state_dict(pair):
    port, ref = pair
    for net in (port, ref):
        net.eval()
        assert not any(m.training for m in net.sublayers(include_self=True))
        net.train()
        assert all(m.training for m in net.sublayers(include_self=True))
    state = {k: ref_np(v) * 0 + 1 for k, v in ref.state_dict().items()}
    state["extra"] = np.zeros(1)
    del state["scale"]
    assert port.set_state_dict(state) == ref.set_state_dict(state)
    np.testing.assert_array_equal(port.a.weight.detach().numpy(),
                                  ref_np(ref.a.weight))
    half = _net(pt.nn, device="cpu").astype("bfloat16")
    assert {p.dtype for p in half.parameters()} == {torch.bfloat16}
    assert half.to(torch.float32).a.weight.dtype == torch.float32


def test_tied_state_loads_with_torch(pair):
    port, _ = pair
    fresh = _net(pt.nn, device="cpu")
    fresh.load_state_dict(port.state_dict())
    torch.testing.assert_close(fresh.b.weight, port.a.weight)


def test_layer_dict_and_parameter_list():
    for nn, dd in ((pt.nn, {"device": "cpu"}), (paddle.nn, {})):
        d = nn.LayerDict({"a": nn.Linear(2, 2, **dd)})
        d["b"] = nn.Linear(2, 3, **dd)
        assert list(d.keys()) == ["a", "b"] and len(d) == 2 and "b" in d
        d.pop("a")
        assert list(d) == ["b"]
        pl = nn.ParameterList()
        pl.append(nn.Linear(2, 2, **dd).weight)
        assert len(pl) == 1 and len(pl.parameters()) == 1
        ll = nn.LayerList([nn.Linear(2, 2, **dd)])
        ll.append(nn.Linear(2, 2, **dd))
        ll.insert(0, nn.Linear(2, 5, **dd))
        assert len(ll) == 3 and ll[0].weight.shape[1] == 5
        seq = nn.Sequential(nn.Linear(2, 2, **dd), nn.ReLU())
        assert len(seq) == 2 and len(seq[:1]) == 1


@pytest.mark.parametrize("make", [
    lambda: pt.nn.Linear(2, 3, device="cpu"),
    lambda: pt.nn.ReLU(),
    lambda: pt.nn.Conv2D(2, 2, 3, device="cpu"),
    lambda: pt.nn.BatchNorm2D(2, device="cpu"),
    lambda: pt.nn.LSTM(2, 3, device="cpu"),
    lambda: pt.nn.MultiHeadAttention(4, 2, device="cpu"),
    lambda: pt.nn.CrossEntropyLoss(),
    lambda: pt.nn.MSELoss(),
    lambda: pt.models.gpt_tiny(device="cpu"),
    lambda: pt.vision.models.LeNet(device="cpu"),
], ids=["Linear", "ReLU", "Conv2D", "BatchNorm2D", "LSTM", "MHA",
        "CrossEntropyLoss", "MSELoss", "gpt_tiny", "LeNet"])
def test_every_layer_is_a_layer(make):
    m = make()
    assert isinstance(m, pt.nn.Layer)
    assert all(isinstance(s, pt.nn.Layer) for s in m.sublayers())
    assert isinstance(m.parameters(), list)


def test_create_parameter_and_global_initializer():
    pt.nn.initializer.set_global_initializer(
        pt.nn.initializer.Constant(0.5), pt.nn.initializer.Constant(-1.0))
    try:
        lin = pt.nn.Linear(3, 2, device="cpu")
        assert torch.all(lin.weight == 0.5) and torch.all(lin.bias == -1.0)
        p = pt.nn.Layer().create_parameter([2, 2], device="cpu")
        assert torch.all(p == 0.5)
    finally:
        pt.nn.initializer.set_global_initializer(None, None)
    p = pt.create_parameter([4], is_bias=True, device="cpu")
    assert isinstance(p, torch.nn.Parameter) and torch.all(p == 0)
    attr = pt.ParamAttr(name="w", initializer=pt.nn.initializer.Constant(3.0),
                        learning_rate=0.5)
    w = pt.nn.Layer().create_parameter([2], attr=attr, device="cpu")
    assert torch.all(w == 3.0) and w.param_name == "w"
    assert w.optimize_attr == {"learning_rate": 0.5}


def test_functional_call_and_jit_roundtrip(pair, tmp_path):
    port, _ = pair
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
    params = {k: v.clone().requires_grad_(True)
              for k, v in port.state_dict().items()
              if v.is_floating_point()}
    out = functional_call(port, params, x)
    torch.testing.assert_close(out, port(x), **TOL)
    out.sum().backward()
    assert params["a.weight"].grad is not None
    prefix = str(tmp_path / "net")
    jit.save(port, prefix, input_spec=[jit.InputSpec([2, 4], "float32")])
    loaded = jit.load(prefix, device="cpu")
    torch.testing.assert_close(loaded(x), port(x).detach(), **TOL)
