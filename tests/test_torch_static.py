"""paddle_tpu_torch.static and static.nn against the JAX package's, on the
CPU at small sizes: each builder on the same numpy inputs with the
reference's parameters carried over by name
(`convert.load_reference_program`), float32 within RTOL/ATOL; the control
flow; the serialized formats read by the other package, both ways; the
rest of static's surface."""

import io
import contextlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as rstatic
import paddle_tpu_torch as pt
from paddle_tpu_torch import static as pstatic
from paddle_tpu_torch.convert import load_reference_program
from torch_one_thread import one_torch_thread  # noqa: F401

# float32 products and reductions in another order on each side
RTOL = ATOL = 1e-5


def _np(t):
    if hasattr(t, "_data"):
        return np.asarray(t._data)
    return t.detach().cpu().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _ref_state(prog):
    return {k: np.asarray(v._data) for k, v in prog.state_dict().items()}


class _Pair:
    """One builder function run in both packages, each under a fresh
    unique_name guard and its own Program."""

    def __init__(self, build, inputs):
        self.build = build
        self.inputs = inputs
        self.rp, self.pp = rstatic.Program(), pstatic.Program()

    def ref(self):
        xs = [paddle.to_tensor(x) for x in self.inputs]
        with paddle.utils.unique_name.guard(), \
                rstatic.program_guard(self.rp):
            return self.build(rstatic, *xs)

    def port(self):
        xs = [torch.tensor(x) for x in self.inputs]
        with pt.utils.unique_name.guard(), pstatic.program_guard(self.pp):
            return self.build(pstatic, *xs)

    def carried(self):
        """Both outputs of a second call, after the reference's parameters
        went into the port's program."""
        self.ref()
        self.port()
        load_reference_program(self.pp, _ref_state(self.rp))
        return self.ref(), self.port()


@pytest.fixture
def on_cpu():
    """The package's default device set to the CPU for the test."""
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


_R = np.random.RandomState(0)


def _x(*shape):
    return _R.standard_normal(shape).astype(np.float32)


BUILDERS = {
    "fc": (lambda s, x: s.nn.fc(x, 5, num_flatten_dims=1,
                                activation="relu"), [_x(2, 3, 4)]),
    "embedding": (lambda s, i: s.nn.embedding(i, (10, 4), padding_idx=0),
                  [np.array([[0, 3, 9], [1, 0, 2]], np.int64)]),
    "conv2d": (lambda s, x: s.nn.conv2d(x, 4, 3, padding=1, act="relu"),
               [_x(2, 3, 8, 8)]),
    "conv3d": (lambda s, x: s.nn.conv3d(x, 3, 3, padding=1), [_x(1, 2, 4, 5,
                                                                 5)]),
    "conv2d_transpose": (lambda s, x: s.nn.conv2d_transpose(
        x, 4, filter_size=3, stride=2), [_x(2, 3, 5, 5)]),
    "conv3d_transpose": (lambda s, x: s.nn.conv3d_transpose(
        x, 2, filter_size=2, stride=2), [_x(1, 2, 3, 3, 3)]),
    "deform_conv2d": (lambda s, x, off, m: s.nn.deform_conv2d(
        x, off, m, 3, 2, padding=1),
        [_x(1, 2, 5, 5), 0.5 * _x(1, 8, 6, 6),
         np.abs(_x(1, 4, 6, 6)) % 1.0]),
    "batch_norm": (lambda s, x: s.nn.batch_norm(x, act="relu"),
                   [_x(4, 3, 5, 5)]),
    "batch_norm_test": (lambda s, x: s.nn.batch_norm(x, is_test=True),
                        [_x(4, 3, 5, 5)]),
    "layer_norm": (lambda s, x: s.nn.layer_norm(x, begin_norm_axis=1),
                   [_x(2, 3, 4)]),
    "group_norm": (lambda s, x: s.nn.group_norm(x, 2), [_x(2, 4, 3, 3)]),
    "instance_norm": (lambda s, x: s.nn.instance_norm(x), [_x(2, 3, 4, 4)]),
    "data_norm": (lambda s, x: s.nn.data_norm(x), [_x(6, 4)]),
    "data_norm_affine": (lambda s, x: s.nn.data_norm(
        x, enable_scale_and_shift=True), [_x(6, 4)]),
    "prelu_all": (lambda s, x: s.nn.prelu(x, "all"), [_x(2, 3, 4, 4)]),
    "prelu_channel": (lambda s, x: s.nn.prelu(x, "channel"),
                      [_x(2, 3, 4, 4)]),
    "prelu_element": (lambda s, x: s.nn.prelu(x, "element"),
                      [_x(2, 3, 4, 4)]),
    "bilinear_tensor_product": (lambda s, x, y: s.nn.bilinear_tensor_product(
        x, y, 2), [_x(3, 4), _x(3, 5)]),
    "spectral_norm": (lambda s, w: s.nn.spectral_norm(w, dim=1,
                                                      power_iters=3),
                      [_x(4, 6)]),
    "row_conv": (lambda s, x: s.nn.row_conv(x, 1), [_x(2, 6, 3)]),
    "named_fc_shared": (lambda s, x: s.nn.fc(x, 3, name="shared")
                        + s.nn.fc(x, 3, name="shared"), [_x(2, 4)]),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_reference(name):
    build, inputs = BUILDERS[name]
    pair = _Pair(build, inputs)
    want, got = pair.carried()
    assert sorted(pair.pp.state_dict()) == sorted(pair.rp.state_dict())
    _close(got, want)
    # the parameters (and batch_norm's moving statistics) moved alike
    for k, v in pair.rp.state_dict().items():
        _close(pair.pp.state_dict()[k], v)


def _two_builders(first, second):
    """A program of two BUILDERS entries, each on its own input (shapes
    the builder tests have compiled already)."""
    (b1, x1), (b2, x2) = BUILDERS[first], BUILDERS[second]
    return _Pair(lambda s, x, y: [b1(s, x), b2(s, y)], x1 + x2)


def test_parameter_names_are_the_references():
    pair = _two_builders("conv2d", "fc")
    pair.ref()
    pair.port()
    assert list(pair.pp.state_dict()) == list(pair.rp.state_dict())
    assert [tuple(v.shape) for v in pair.pp.state_dict().values()] == \
        [tuple(v.shape) for v in pair.rp.state_dict().values()]
    for k, v in pair.pp.state_dict().items():
        assert v.param_name == k


def test_builder_reuses_a_named_parameter_and_checks_its_shape():
    prog = pstatic.Program()
    x = torch.ones(2, 4)
    with pstatic.program_guard(prog):
        a = pstatic.nn.fc(x, 3, name="f")
        b = pstatic.nn.fc(x, 3, name="f")
        assert torch.equal(a, b) and len(prog.state_dict()) == 2
        with pytest.raises(ValueError, match="already exists"):
            pstatic.nn.fc(torch.ones(2, 5), 3, name="f")
    pstatic.nn.reset_parameters()


def test_builders_make_parameters_on_the_inputs_device():
    prog = pstatic.Program()
    with pstatic.program_guard(prog):
        pstatic.nn.batch_norm(torch.ones(2, 3, 2, 2))
    assert {v.device.type for v in prog.state_dict().values()} == {"cpu"}
    assert len(prog.state_dict(mode="param")) == 2
    assert len(prog.state_dict()) == 4


@pytest.mark.parametrize("flag", [True, False])
def test_case_and_switch_case(flag):
    def build(s, x):
        one = s.nn.case([(x.sum() > 0 if flag else x.sum() < -1e9,
                          lambda: x * 2)], default=lambda: x - 1)
        two = s.nn.case([(x.sum() < -1e9, lambda: x * 3),
                         (x.sum() > -1e9, lambda: x * 4)])
        idx = 1 if flag else 7
        three = s.nn.switch_case(idx, {0: lambda: x + 10, 1: lambda: x + 20,
                                       3: lambda: x + 30})
        four = s.nn.switch_case(idx, [lambda: x * 0, lambda: x + 5],
                                default=lambda: x - 5)
        return [one, two, three, four]
    pair = _Pair(build, [_x(3)])
    for got, want in zip(pair.port(), pair.ref()):
        _close(got, want)


def test_py_func_and_static_pylayer():
    x = _x(3, 2)

    def fn(a):
        return a * 3 + 1
    want = rstatic.nn.py_func(fn, paddle.to_tensor(x),
                              paddle.to_tensor(np.zeros((3, 2), np.float32)))
    got = pstatic.nn.py_func(fn, torch.tensor(x), torch.zeros(3, 2))
    _close(got, want)
    with pytest.raises(ValueError, match="declared"):
        pstatic.nn.py_func(fn, torch.tensor(x), torch.zeros(2, 2))
    t = torch.tensor(x, requires_grad=True)
    y = pstatic.nn.static_pylayer(lambda a: a * 2, [t],
                                  backward_fn=lambda g: g * 5)
    y.sum().backward()
    assert torch.equal(y, t.detach() * 2)
    assert torch.equal(t.grad, torch.full_like(t, 5.0))


@pytest.mark.parametrize("pred", [True, False])
def test_cond_matches_reference(pred):
    x = _x(4)
    want = rstatic.cond(paddle.to_tensor(np.array(pred)),
                        lambda: paddle.to_tensor(x) * 2,
                        lambda: paddle.to_tensor(x) - 1)
    got = pstatic.cond(torch.tensor(pred), lambda: torch.tensor(x) * 2,
                       lambda: torch.tensor(x) - 1)
    _close(got, want)
    assert pstatic.nn.cond is pstatic.cond


def test_while_loop_matches_reference():
    want = rstatic.while_loop(
        lambda i, s: i < 6, lambda i, s: [i + 1, s + i * 2],
        [paddle.to_tensor(np.array(0, np.int32)),
         paddle.to_tensor(np.array(0.5, np.float32))])
    got = pstatic.while_loop(
        lambda i, s: i < 6, lambda i, s: [i + 1, s + i * 2],
        [torch.tensor(0), torch.tensor(0.5)])
    assert isinstance(got, list) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)


def test_scan_matches_reference():
    init, xs = _x(3), _x(5, 3)

    def body(c, x):
        return c * 0.5 + x, c * x
    w_carry, w_ys = rstatic.scan(body, paddle.to_tensor(init),
                                 paddle.to_tensor(xs))
    g_carry, g_ys = pstatic.scan(body, torch.tensor(init), torch.tensor(xs))
    _close(g_carry, w_carry)
    _close(g_ys, w_ys)
    assert tuple(g_ys.shape) == (5, 3)


def _programs():
    """A reference program and the port's with the same names and other
    values."""
    pair = _two_builders("batch_norm", "fc")
    pair.ref()
    pair.port()
    return pair.rp, pair.pp


@pytest.mark.parametrize("what", ["program", "persistables"])
def test_npz_bytes_both_ways(what):
    rp, pp = _programs()
    ser = getattr(rstatic, f"serialize_{what}")
    pser = getattr(pstatic, f"serialize_{what}")
    ref_bytes = ser(rp)
    if what == "program":
        got = pstatic.deserialize_program(ref_bytes)
        back = rstatic.deserialize_program(pser(pp))
    else:
        target = pstatic.Program()
        target._params = {k: v.clone() for k, v in pp.state_dict().items()}
        pstatic.deserialize_persistables(target, ref_bytes)
        got = target
        back = rstatic.Program()
        back._params = {k: paddle.to_tensor(np.asarray(v._data).copy())
                        for k, v in rp.state_dict().items()}
        rstatic.deserialize_persistables(back, pser(pp))
    for k, v in rp.state_dict().items():
        _close(got.state_dict()[k], v, 0, 0)
    for k, v in pp.state_dict().items():
        _close(back.state_dict()[k], v, 0, 0)


def test_npz_bytes_carry_bfloat16_as_float32():
    prog = pstatic.Program()
    prog._params = {"w": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    data = pstatic.serialize_program(prog)
    ref = rstatic.deserialize_program(data)
    assert np.asarray(ref.state_dict()["w"]._data).dtype == np.float32
    target = pstatic.Program()
    target._params = {"w": torch.zeros(2, dtype=torch.bfloat16)}
    pstatic.deserialize_persistables(target, data)
    assert torch.equal(target.state_dict()["w"], prog._params["w"])


def test_save_and_load_both_ways(tmp_path):
    rp, pp = _programs()
    rstatic.save(rp, str(tmp_path / "ref"))
    pstatic.save(pp, str(tmp_path / "port"))
    _, target = _programs()
    state = pstatic.load(target, str(tmp_path / "ref"))
    assert sorted(state) == sorted(rp.state_dict())
    for k, v in rp.state_dict().items():
        _close(target.state_dict()[k], v, 0, 0)
    rtarget, _ = _programs()
    rstatic.load(rtarget, str(tmp_path / "port"))
    for k, v in pp.state_dict().items():
        _close(rtarget.state_dict()[k], v, 0, 0)
    assert sorted(pstatic.load_program_state(str(tmp_path / "ref"))) == \
        sorted(rp.state_dict())


def test_inference_model_program_form_both_ways(tmp_path, on_cpu):
    rp, pp = _programs()
    feed_r = rstatic.data("img", [-1, 3, 5, 5])
    feed_p = pstatic.data("img", [-1, 3, 5, 5])
    rstatic.save_inference_model(str(tmp_path / "r"), [feed_r], [],
                                 program=rp)
    pstatic.save_inference_model(str(tmp_path / "p"), [feed_p], [],
                                 program=pp)
    _, target = _programs()
    prog, feeds, fetches = pstatic.load_inference_model(
        str(tmp_path / "r"), program=target)
    assert feeds == ["img"] and fetches == []
    for k, v in rp.state_dict().items():
        _close(prog.state_dict()[k], v, 0, 0)
        _close(target.state_dict()[k], v, 0, 0)
    rprog, rfeeds, _ = rstatic.load_inference_model(str(tmp_path / "p"))
    assert rfeeds == ["img"]
    for k, v in pp.state_dict().items():
        _close(rprog.state_dict()[k], v, 0, 0)


def test_inference_model_layer_form(tmp_path):
    torch.manual_seed(0)
    layer = pt.nn.Linear(4, 3, device="cpu")
    prefix = str(tmp_path / "lin")
    pstatic.save_inference_model(prefix, [], [], layer=layer)
    prog, feeds, fetches = pstatic.load_inference_model(prefix,
                                                        device="cpu")
    assert isinstance(prog, pstatic.Program) and feeds == []
    for k, v in layer.state_dict().items():
        assert torch.equal(fetches[0].state_dict()[k], v)
    with pytest.raises(RuntimeError, match="without input_spec"):
        fetches[0](torch.zeros(2, 4))


def test_inference_model_layer_form_runs_its_program(tmp_path):
    """With input_spec= the layer form also writes the exported program,
    and the loaded artefact runs it: its outputs are the layer's."""
    torch.manual_seed(0)
    layer = pt.nn.Sequential(pt.nn.Linear(4, 8, device="cpu"), pt.nn.ReLU(),
                             pt.nn.Linear(8, 3, device="cpu"))
    x = torch.as_tensor(np.random.RandomState(0).randn(2, 4),
                        dtype=torch.float32)
    prefix = str(tmp_path / "mlp")
    pstatic.save_inference_model(
        prefix, [], [], layer=layer,
        input_spec=[pstatic.InputSpec([2, 4], "float32")])
    _, _, fetches = pstatic.load_inference_model(prefix, device="cpu")
    assert fetches[0].program is not None
    with torch.no_grad():
        want = layer(x)
    np.testing.assert_allclose(fetches[0](x).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_program_surface_as_the_reference():
    rp, pp = _programs()
    assert pp.to_string() == rp.to_string() == str(pp)
    for mode in ("all", "param", "opt"):
        assert sorted(pp.state_dict(mode)) == sorted(rp.state_dict(mode))
    with pytest.raises(ValueError):
        pp.state_dict("bogus")
    assert len(pp.all_parameters()) == len(rp.all_parameters())
    assert pp.global_block() is pp
    clone = pp.clone()
    assert clone.state_dict().keys() == pp.state_dict().keys()
    with pytest.warns(UserWarning, match="unknown"):
        pp.set_state_dict({"nope": np.zeros(1)})
    key = next(iter(pp.state_dict()))
    with pytest.raises(ValueError, match="elements"):
        pp.set_state_dict({key: np.zeros(10**3 + 7)})


def test_default_programs_and_guards():
    assert pstatic.default_main_program() is pstatic.default_main_program()
    assert pstatic.default_startup_program() is not \
        pstatic.default_main_program()
    before = len(pstatic.default_main_program().state_dict())
    with pstatic.name_scope("x"), pstatic.device_guard("gpu"):
        pstatic.nn.fc(torch.ones(1, 2), 2, name="default_prog_fc")
    assert len(pstatic.default_main_program().state_dict()) == before + 2
    pstatic.nn.reset_parameters()
    assert pstatic.default_main_program().state_dict() == {}


def test_data_and_global_var(on_cpu):
    d = pstatic.data("ids", [None, 3], dtype="int64", lod_level=0)
    r = rstatic.data("ids", [None, 3], dtype="int64")
    assert tuple(d.shape) == tuple(r.shape) == (1, 3)
    assert d.dtype == torch.int64 and d.param_name == "ids"
    g = pstatic.create_global_var([2], 1.5, "float32", persistable=True,
                                  force_cpu=True, name="g")
    assert torch.equal(g, torch.full((2,), 1.5)) and g.persistable
    p = pstatic.create_parameter([3, 2], "float32", name="cp")
    assert p.param_name == "cp" and tuple(p.shape) == (3, 2)
    assert pstatic.InputSpec is pt.jit.InputSpec
    assert pstatic.Variable is torch.Tensor


def test_executor_print_auc_accuracy():
    x = _x(6, 2)
    exe = pstatic.Executor(pstatic.cpu_places()[0])
    out = exe.run(feed={"a": 2}, fetch_list=[lambda a: a + 1,
                                             torch.tensor(x)])
    assert out[0] == 3 and np.array_equal(out[1], x)
    exe.close()
    buf_p, buf_r = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf_p):
        pstatic.Print(torch.tensor(x), message="m", summarize=5)
    with contextlib.redirect_stdout(buf_r):
        rstatic.Print(paddle.to_tensor(x), message="m", summarize=5)
    assert buf_p.getvalue() == buf_r.getvalue()
    label = np.array([0, 1, 1, 0, 1, 0], np.int64)
    got = pstatic.auc(torch.tensor(x), torch.tensor(label))
    want = rstatic.auc(paddle.to_tensor(x), paddle.to_tensor(label))
    _close(got[0], want[0], 1e-6, 1e-6)
    assert got[2] == [] == want[2]
    assert pstatic.py_func(lambda a, b: a + b, [1, 2], None) == \
        rstatic.py_func(lambda a, b: a + b, [1, 2], None) == 3
    lab = label.reshape(-1, 1)
    _close(pstatic.accuracy(torch.tensor(x), torch.tensor(lab)),
           rstatic.accuracy(paddle.to_tensor(x), paddle.to_tensor(lab)))


def test_append_backward_and_gradients():
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    b = torch.nn.Parameter(torch.tensor(0.5))
    x = torch.tensor([3.0, -1.0])
    loss = ((w * x).sum() + b) ** 2
    pairs = pstatic.append_backward(loss)
    assert {id(p) for p, _ in pairs} == {id(w), id(b)}
    v = float((w * x).sum() + b)
    assert torch.allclose(w.grad, 2 * v * x) and float(b.grad) == 2 * v
    y = torch.tensor([2.0], requires_grad=True)
    (g,) = pstatic.gradients([y ** 3], [y])
    assert torch.allclose(g, torch.tensor([12.0]))


def test_exponential_moving_average_matches_reference():
    w0 = np.array([1.0, 2.0], np.float32)
    rp = paddle.create_parameter([2], "float32")
    rp.set_value(w0)
    pp = torch.nn.Parameter(torch.tensor(w0))
    r_ema, p_ema = rstatic.ExponentialMovingAverage(0.9), \
        pstatic.ExponentialMovingAverage(0.9)
    for step in range(3):
        r_ema.update([rp])
        p_ema.update([pp])
        new = w0 * (step + 2)
        rp.set_value(new)
        with torch.no_grad():
            pp.copy_(torch.tensor(new))
    with r_ema.apply(), p_ema.apply():
        _close(pp, rp)
        inside = pp.detach().clone()
    _close(pp, rp)
    assert not torch.equal(inside, pp.detach())


def test_places_and_descoped_names():
    assert len(pstatic.cpu_places(3)) == 3
    assert pstatic.cuda_places() == [pt.CUDAPlace(i) for i in
                                     range(torch.cuda.device_count())]
    assert pstatic.global_scope().find_var("x") is None
    with pstatic.scope_guard(pstatic.global_scope()):
        pass
    assert "program" in str(pstatic.CompiledProgram(pstatic.Program(),
                                                    pstatic.BuildStrategy()))
    assert pstatic.normalize_program("p", [], []) == "p"
    for fn in (pstatic.xpu_places, pstatic.IpuStrategy,
               pstatic.IpuCompiledProgram, pstatic.ctr_metric_bundle,
               pstatic.nn.sequence_conv, pstatic.nn.sequence_pool,
               pstatic.nn.nce, pstatic.nn.sparse_embedding):
        with pytest.raises(NotImplementedError):
            fn(None, None) if fn is pstatic.ctr_metric_bundle else fn()
    with pytest.raises(NotImplementedError):
        with pstatic.ipu_shard_guard():
            pass
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pstatic.set_program_state(pstatic.Program(), {})
