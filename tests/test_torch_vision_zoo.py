"""The port's vision zoo against the JAX package's (tests/torch_zoo_parity.py
says how weights are carried and what each tolerance is): every new
constructor's state keys and shapes and its arguments; the MobileNet
family's logits in eval and training mode at the reference's own test
sizes (tests/test_zoo_audio_text.py: mobilenet_v1/v2 at scale 0.25,
v3_small at 0.5, v3_large at 0.35, 32 x 32); the loss and every gradient
of MobileNetV2 (depthwise convolutions, ReLU6, residuals) and
MobileNetV3-Small (hardswish, squeeze-excitation's hardsigmoid) against
jax.grad at b4 64 x 64; the running statistics after a training forward;
bf16 logits; the activations and tensor ops the zoo calls; and
tools/train_resnet's `zoo_config` and `run_one` on the CPU. DenseNet and
the small nets are in test_torch_vision_zoo_dense.py, GoogLeNet and
InceptionV3 in test_torch_vision_zoo_inception.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import torch_zoo_parity as Z
from paddle_tpu.nn import functional as JF
from paddle_tpu.tensor import manipulation as jman
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import tensor as pman
from paddle_tpu_torch.convert import state_from_reference
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.layer.norm import _BatchNormBase
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import train_resnet
from paddle_tpu_torch.vision import models as pmodels
from paddle_tpu_torch.vision.models import densenet as pdensenet
from paddle_tpu_torch.vision.models import inception as pinception
from paddle_tpu_torch.vision.models import mobilenet as pmobilenet
from paddle_tpu_torch.vision.models import small_nets as psmall


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with a worker's default threads under xdist,
    every worker's CPU kernels contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the 21 constructors of the reference's mobilenet.py, densenet.py,
# small_nets.py and inception.py
CONSTRUCTORS = ["mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
                "mobilenet_v3_large", "densenet121", "densenet161",
                "densenet169", "densenet201", "densenet264", "alexnet",
                "squeezenet1_0", "squeezenet1_1", "shufflenet_v2_x0_25",
                "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
                "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
                "shufflenet_v2_x2_0", "shufflenet_v2_swish", "googlenet",
                "inception_v3"]


# -- structure ---------------------------------------------------------------

@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_state_matches_reference(name):
    """At full width with 1000 classes: the same parameters in the same
    order, then the same buffers, with equal shapes; buffers in float32;
    and the converter takes the reference's state."""
    ref = Z.reference_model(name)
    port = getattr(pmodels, name)(device="cpu")
    ref_params = [k for k, _ in ref.named_parameters()]
    ref_state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    assert [k for k, _ in port.named_parameters()] == ref_params
    assert [k for k, _ in port.named_buffers()] == \
        [k for k in ref_state if k not in ref_params]
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref_state.items()}
    for k, v in port.named_buffers():
        assert v.dtype == torch.float32, k
    assert set(state_from_reference(ref_state, "cpu")) == set(ref_state)


_CLASSES = {"MobileNetV1": pmobilenet, "MobileNetV2": pmobilenet,
            "MobileNetV3Small": pmobilenet, "MobileNetV3Large": pmobilenet,
            "DenseNet": pdensenet, "AlexNet": psmall, "SqueezeNet": psmall,
            "ShuffleNetV2": psmall, "GoogLeNet": pinception,
            "InceptionV3": pinception}


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_arguments_match_reference(name, monkeypatch):
    """Each constructor builds its class with the reference's arguments
    (the classes replaced by a recorder on both sides, so nothing is
    built); `pretrained` is accepted."""
    import importlib
    seen = {}

    def recorder(side, cls):
        def record(*args, **kw):
            seen[side] = (cls, args, kw)
        return record
    for cls, pmod in _CLASSES.items():
        jmod = importlib.import_module(
            "paddle_tpu.vision.models." + pmod.__name__.rsplit(".", 1)[1])
        monkeypatch.setattr(jmod, cls, recorder("ref", cls))
        monkeypatch.setattr(pmod, cls, recorder("port", cls))
    getattr(jmodels, name)(pretrained=False, num_classes=7)
    getattr(pmodels, name)(pretrained=False, num_classes=7)
    assert seen["port"] == seen["ref"]


def test_default_device_is_cuda():
    """Without a device the models and zoo_config's step build on CUDA,
    which raises where there is none; device="cpu" builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmodels.mobilenet_v2()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_resnet.TrainStep(train_resnet.zoo_config("mobilenet_v2",
                                                       "cuda"))
    net = pmodels.mobilenet_v2(scale=0.25, device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}


# -- the MobileNet family ------------------------------------------------------

MOBILENETS = [("mobilenet_v1", dict(scale=0.25)),
              ("mobilenet_v2", dict(scale=0.25)),
              ("mobilenet_v3_small", dict(scale=0.5)),
              ("mobilenet_v3_large", dict(scale=0.35))]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,kw", MOBILENETS,
                         ids=[n for n, _ in MOBILENETS])
def test_mobilenet_logits_match_reference(name, kw, training):
    x, _ = Z.images(hw=32)
    Z.check_logits(name, x, training, num_classes=10, **kw)


@pytest.mark.parametrize("name,kw", [MOBILENETS[1], MOBILENETS[2]],
                         ids=["mobilenet_v2", "mobilenet_v3_small"])
def test_mobilenet_loss_and_gradients_match_jax_grad(name, kw):
    x, y = Z.images(hw=64)
    Z.check_grads(name, x, y, num_classes=10, **kw)


def test_running_stats_match_the_reference_eager_forward():
    """One eager training forward of mobilenet_v2 on each side: every
    batch norm's `_mean` and `_variance` moved the same way."""
    ref, port, np_state = Z.case("mobilenet_v2", scale=0.25, num_classes=10)
    for k, t in ref.state_dict().items():
        t._data = jnp.asarray(np_state[k])
    x, _ = Z.images(1, b=4, hw=32)
    Z.set_mode(ref, True)
    Z.set_mode(port, True)
    ref(paddle.Tensor(x))
    with torch.no_grad():
        port(torch.as_tensor(x))
    want = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(v.numpy(), want[k], rtol=Z.F32_TOL,
                                       atol=Z.F32_TOL, err_msg=k)
            moved += k.endswith("_mean") and bool(v.abs().max() > 0)
    n_bn = sum(isinstance(m, _BatchNormBase) for m in port.modules())
    assert n_bn == 52 and moved == n_bn       # every running mean moved


def test_bf16_logits_match_reference():
    """mobilenet_v2 with its parameters and buffers in bf16 on both sides,
    bf16 images, training mode: the logits within BF16_TOL of the largest
    |logit|, or the reference's own bf16 error against its float32
    result at the same bf16-rounded weights and images where larger."""
    ref, port, np_state = Z.case("mobilenet_v2", scale=0.25, num_classes=10)
    x, _ = Z.images(3, b=4, hw=64)
    low = Z.ref_forward(ref, np_state, x, True, jnp.bfloat16)[0]
    rounded = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(
        jnp.float32)) for k, v in np_state.items()}
    xr = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    high = Z.ref_forward(ref, rounded, xr, True)[0]
    scale = np.abs(high).max()
    tol = max(Z.BF16_TOL, np.abs(low - high).max() / scale)
    port.to(torch.bfloat16)
    got = Z.port_forward(port, x, True, torch.bfloat16)[0]
    assert np.abs(got - low).max() / np.abs(low).max() <= tol


# -- the activations and tensor ops the zoo calls -----------------------------

@pytest.mark.parametrize("fn", ["relu6", "hardswish", "hardsigmoid",
                                "swish"])
def test_activation_and_gradient_match_reference(fn):
    """On values that hit the kinks (0, +-3, 6) and between them; the
    gradient of sum(f(x) * cotangent)."""
    import jax
    rs = np.random.RandomState(0)
    x = np.concatenate([np.array([-6.0, -3.0, -1e-3, 0.0, 1e-3, 3.0, 6.0,
                                  7.0], np.float32),
                        rs.uniform(-8, 8, 56).astype(np.float32)])
    cot = rs.randn(64).astype(np.float32)
    jf = getattr(JF, fn)
    want = np.asarray(jf(paddle.Tensor(x))._data)
    want_g = np.asarray(jax.grad(lambda a: (jf(paddle.Tensor(a))._data
                                            * cot).sum())(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    out = getattr(PF, fn)(t)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=Z.F32_TOL,
                               atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=Z.F32_TOL,
                               atol=1e-6)


def test_hardsigmoid_is_the_reference_slope_not_torch():
    """0.1666667 x + 0.5, not torch's x / 6 + 0.5: they part in float32
    at x = 2.5."""
    x = torch.tensor([2.5])
    assert PF.hardsigmoid(x).item() == np.float32(
        np.float32(0.1666667) * np.float32(2.5) + np.float32(0.5))
    assert PF.hardsigmoid(x).item() != torch.nn.functional.hardsigmoid(
        x).item()


def test_tensor_ops_match_reference():
    """concat, reshape (a -1 and a tensor shape), transpose (a perm, and
    None: all axes reversed) and split (equal pieces, sections with -1)."""
    rs = np.random.RandomState(0)
    a = rs.randn(2, 3, 4, 5).astype(np.float32)
    b = rs.randn(2, 2, 4, 5).astype(np.float32)
    ja, jb, ta, tb = (paddle.Tensor(a), paddle.Tensor(b), torch.tensor(a),
                      torch.tensor(b))

    def same(port, ref):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref._data))
    same(pman.concat([ta, tb], axis=1), jman.concat([ja, jb], axis=1))
    same(pman.reshape(ta, [2, -1, 5]), jman.reshape(ja, [2, -1, 5]))
    same(pman.reshape(ta, torch.tensor([6, 20])), jman.reshape(ja, [6, 20]))
    same(pman.transpose(ta, [0, 2, 1, 3]), jman.transpose(ja, [0, 2, 1, 3]))
    same(pman.transpose(ta), jman.transpose(ja))
    for got, want in zip(pman.split(ta, 5, axis=3),
                         jman.split(ja, 5, axis=3)):
        same(got, want)
    for got, want in zip(pman.split(ta, [1, -1], axis=1),
                         jman.split(ja, [1, -1], axis=1)):
        same(got, want)
    with pytest.raises(ValueError):
        pman.split(ta, 2, axis=1)


# -- tools/train_resnet on the zoo ---------------------------------------------

@pytest.mark.parametrize("name", ["googlenet", "alexnet"])
def test_run_one_trains_a_zoo_model_on_the_cpu(name):
    """zoo_config's CPU configuration (10 classes, b2 64 x 64, float32):
    finite losses, no flash-kernel launch. GoogLeNet's tuple output trains
    on its main head; AlexNet has no batch norm, so no stem statistic."""
    before = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
              fa.flash_bwd_dkv_launches)
    cfg = train_resnet.zoo_config(name, "cpu")
    assert (cfg.batch, cfg.hw, cfg.dtype, cfg.classes) == \
        (2, 64, "float32", 10)
    r = train_resnet.run_one(cfg, device="cpu")
    assert r["resnet_variant"] == f"{name}_64_cpu"
    assert len(r["losses"]) == cfg.steps + 1
    assert np.isfinite(r["losses"]).all()
    assert r["launches_per_step"] == [{"flash_fwd": 0, "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0}] * cfg.steps
    assert (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches) == before
    if name == "alexnet":
        assert r["stem_mean_absmax"] is None
    else:
        assert r["stem_mean_absmax"] > 0 and r["running_stats_finite"]


def test_googlenet_step_takes_the_main_head_loss():
    """TrainStep's loss of GoogLeNet is the cross-entropy of its first
    output."""
    cfg = train_resnet.zoo_config("googlenet", "cpu")
    train = train_resnet.TrainStep(cfg, "cpu")
    # dropout off, so that two forwards agree; training mode's batch
    # statistics normalise both
    Z.set_mode(train.model, True)
    with torch.no_grad():
        want = PF.cross_entropy(train.model(train.x)[0], train.y)
    assert train.step(1).item() == pytest.approx(want.item(), rel=1e-6)


def test_zoo_config_on_the_card():
    """The card's configuration: 1000 classes at the published size, b64,
    bf16, 8 steps; inception_v3 at 299 x 299."""
    cfg = train_resnet.zoo_config("mobilenet_v2", "cuda")
    assert (cfg.variant, cfg.batch, cfg.hw, cfg.steps, cfg.dtype,
            cfg.classes) == ("mobilenet_v2_224", 64, 224, 8, "bfloat16",
                             1000)
    assert train_resnet.zoo_config("inception_v3", "cuda").hw == 299
    assert train_resnet.bench_config("cuda").variant == "resnet50_224"
