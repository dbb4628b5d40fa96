"""The port's vision models (vision/models: ResNet and its variants, VGG,
LeNet) and tools/train_resnet against the JAX package's, with the
reference's weights carried across by paddle_tpu_torch.convert:

- state-dict keys and shapes, parameters and the batch norms'
  `_mean`/`_variance` buffers, and each of the thirteen ResNet
  constructors' arguments;
- `run_one`'s keys on the CPU, ResNet-50's MACs and train_resnet's
  default device;
- the converter: ResNet, VGG and LeNet states, and one of each family
  the zoo added (MobileNet V1-V3, DenseNet, AlexNet, SqueezeNet,
  ShuffleNetV2, GoogLeNet, InceptionV3), carry across, and a state with a
  missing, an unexpected or a reshaped key raises.

The models' numbers (resnet18's logits, gradients, running statistics and
bf16, the BottleneckBlocks, VGG and LeNet, bench.py's ResNet step) are
tests/test_torch_vision_resnet.py's, with this file's helpers.

Inputs come from numpy seeds. float32 parity is within F32_TOL (the same
math summed in other orders; the loss within LOSS_RTOL, the gradients
within GRAD_TOL of the largest |gradient| of their tensor, parameters
after the Momentum steps within STEP_TOL). Where float32 rounding alone
moves a result further (the port's float32 against a float64 copy of it:
training-mode batch norms over two values a channel at b2 32x32, several
Momentum steps at lr 0.1), the bound is three times that. bfloat16 is held
within BF16_TOL of the largest |value|, the bound tests/test_torch_bert.py
holds bf16 to, or within the reference's own bf16 error against its
float32 result where that is larger (`_bf16_tol` in
tests/test_torch_vision_resnet.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.convert import load_reference_state, \
    state_from_reference
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import train_resnet
from paddle_tpu_torch.vision import models as pmodels
from paddle_tpu_torch.vision.models import resnet as presnet

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with a worker's default threads under xdist,
    every worker's CPU kernels contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _build(lib, name, **kw):
    """`name` of `lib` (the reference's models or the port's), or with name
    "bottleneck" ResNet-50's layout of BottleneckBlocks at groups 2 and
    width 4 (3x3 convolutions 8-64 wide), 10 classes."""
    if name == "bottleneck":
        return lib.resnet.ResNet(lib.resnet.BottleneckBlock, 50, width=4,
                                 groups=2, num_classes=10, **kw)
    return getattr(lib, name)(**kw)


@functools.lru_cache(maxsize=None)
def _reference_state(name, seed=0):
    """The reference's state of `name` with 10 classes (LeNet's default)
    from `seed`, as numpy arrays; callers copy before changing it."""
    paddle.seed(seed)
    return _np_state(getattr(jmodels, name)(num_classes=10))


def _pair(name, seed=0, **kw):
    paddle.seed(seed)
    ref = _build(jmodels, name, **kw)
    port = _build(pmodels, name, device="cpu", **kw)
    load_reference_state(port, _np_state(ref))
    return ref, port


def _images(seed=0, b=4, c=3, hw=64):
    rs = np.random.RandomState(seed)
    return rs.randn(b, c, hw, hw).astype(np.float32), rs.randint(0, 10, (b,))


def _j(a, dtype=jnp.float32):
    return paddle.Tensor(jnp.asarray(a).astype(dtype))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# -- structure --------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("resnet18", dict(num_classes=10)),
    ("resnet50", dict(num_classes=0, with_pool=False)),
    ("vgg11", dict(batch_norm=True, num_classes=10)),
    ("LeNet", {}),
], ids=["resnet18", "resnet50", "vgg11_bn", "lenet"])
def test_state_dict_keys_and_shapes_match_reference(name, kw):
    """The same parameters in the same order, then the same buffers (torch
    lists a module's buffers beside its parameters; the reference lists
    all parameters first), with equal shapes; buffers in float32; and the
    converter's map of the family takes the reference's state."""
    import torch_zoo_parity
    # the reference's initializers give zeros: only keys and shapes count
    with torch_zoo_parity.zero_reference_init():
        ref = getattr(jmodels, name)(**kw)
    port = getattr(pmodels, name)(device="cpu", **kw)
    ref_params = [k for k, _ in ref.named_parameters()]
    ref_state = _np_state(ref)
    assert [k for k, _ in port.named_parameters()] == ref_params
    assert [k for k, _ in port.named_buffers()] == \
        [k for k in ref_state if k not in ref_params]
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref_state.items()}
    for k, v in port.named_buffers():
        assert v.dtype == torch.float32, k
    assert set(state_from_reference(ref_state, "cpu")) == set(ref_state)


RESNETS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x4d", "resnext50_64x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]


@pytest.mark.parametrize("name", RESNETS)
def test_resnet_constructors_match_reference(name, monkeypatch):
    """Each constructor builds ResNet with the reference's block, depth,
    groups and width (ResNet itself replaced by a recorder on both
    sides, so nothing is built)."""
    from paddle_tpu.vision.models import resnet as jresnet
    seen = {}

    def recorder(side):
        def record(block, depth, **kw):
            seen[side] = (block.__name__, depth, kw)
        return record
    monkeypatch.setattr(jresnet, "ResNet", recorder("ref"))
    monkeypatch.setattr(presnet, "ResNet", recorder("port"))
    getattr(jmodels, name)(num_classes=7)
    getattr(pmodels, name)(num_classes=7)
    assert seen["port"] == seen["ref"]


def test_conv_init_bounds():
    """Convolutions draw from Uniform(+-1/sqrt(fan_in)), not Kaiming; the
    stem (3 x 7 x 7 fan-in) and a 3x3 of 64 channels."""
    torch.manual_seed(0)
    port = pmodels.resnet18(num_classes=10, device="cpu")
    for w, fan_in in ((port.conv1.weight, 3 * 49),
                      (port.layer1[0].conv1.weight, 64 * 9)):
        bound = 1.0 / np.sqrt(fan_in)
        assert bound * 0.98 < w.abs().max() <= bound
    assert port.conv1.bias is None


def _vgg_pair():
    return _pair("vgg11", batch_norm=True, num_classes=10)


# -- the training tool: bench.py's ResNet step ------------------------------

def test_run_one_on_the_cpu():
    """bench.py's keys, finite losses, no flash-kernel launch, no MFU or
    device memory off the card, and FLOPs counted from the model's own
    convolutions and linear layers."""
    before = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
              fa.flash_bwd_dkv_launches)
    cfg = train_resnet.bench_config("cpu")
    r = train_resnet.run_one(cfg, device="cpu")
    assert {"resnet_images_per_s", "resnet_batch", "resnet_loss",
            "resnet_variant", "resnet_mfu"} <= set(r)
    assert (r["resnet_batch"], r["resnet_variant"]) == (2, "resnet18_32_cpu")
    assert len(r["losses"]) == cfg.steps + 1
    assert np.isfinite(r["losses"]).all() and r["resnet_loss"] == \
        r["losses"][-1]
    assert r["resnet_mfu"] is None and r["peak_memory_bytes"] is None
    assert r["launches_per_step"] == [{"flash_fwd": 0, "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0}] * cfg.steps
    assert (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches) == before
    # resnet18 at 32x32: stem 64x16x16 outputs of 3*49 MACs, ... as counted
    # layer by layer below, then the 512 -> 10 head
    macs = (64 * 16 * 16 * 3 * 49 + 4 * 64 * 8 * 8 * 64 * 9
            + 128 * 4 * 4 * (64 * 9 + 3 * 128 * 9 + 64)
            + 256 * 2 * 2 * (128 * 9 + 3 * 256 * 9 + 128)
            + 512 * 1 * 1 * (256 * 9 + 3 * 512 * 9 + 256) + 10 * 512)
    assert r["flops_per_step"] == 6 * 2 * macs


def test_resnet50_macs_per_image():
    """About 4.1 G multiply-adds a 224x224 image through ResNet-50's
    convolutions and head, as the model's own shapes count them."""
    model = pmodels.resnet50(device="cpu")
    macs = train_resnet.conv_linear_macs(model, torch.zeros(1, 3, 224, 224))
    assert 4.08e9 < macs < 4.12e9
    assert model.training


def test_train_resnet_defaults_to_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works")
    monkeypatch.setattr("sys.argv", ["train_resnet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_resnet.main()


# -- convert.py --------------------------------------------------------------

# one constructor of each family the zoo added, at sizes that build fast;
# AlexNet's and SqueezeNet's states hold `features.0.weight` with three
# input channels, as VGG's do
ZOO_FAMILIES = [
    ("mobilenet_v1", dict(scale=0.25, num_classes=10)),
    ("mobilenet_v2", dict(scale=0.5, num_classes=0)),
    ("mobilenet_v3_small", dict(scale=0.5, num_classes=10)),
    ("mobilenet_v3_large", dict(scale=0.35, num_classes=10)),
    ("densenet121", dict(num_classes=10)),
    ("alexnet", dict(num_classes=10)),
    ("squeezenet1_0", dict(num_classes=10)),
    ("squeezenet1_1", dict(num_classes=0)),
    ("shufflenet_v2_x0_33", dict(num_classes=10)),
    ("googlenet", dict(num_classes=10)),
    ("inception_v3", dict(num_classes=10)),
]


@functools.lru_cache(maxsize=None)
def _zoo_state(name):
    """A reference state of the zoo family `name` (ZOO_FAMILIES' arguments):
    the reference model's keys and shapes (built with its initializers
    giving zeros, tests/torch_zoo_parity.py), values from a numpy seed."""
    import torch_zoo_parity
    kw = dict(ZOO_FAMILIES)[name]
    ref = torch_zoo_parity.reference_model(name, **kw)
    rs = np.random.RandomState(len(name))
    return {k: rs.randn(*np.shape(v._data)).astype(np.float32)
            for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("name,kw", [
    ("resnet18", dict(num_classes=10)),
    ("vgg11", dict(batch_norm=True, num_classes=10)),
    ("vgg13", dict(num_classes=0)),
    ("LeNet", {}),
] + ZOO_FAMILIES, ids=["resnet18", "vgg11_bn", "vgg13_features", "lenet"]
    + [n for n, _ in ZOO_FAMILIES])
def test_state_carries_across(name, kw):
    paddle.seed(2)
    np_state = (_np_state(_vgg_pair()[0]) if name == "vgg11" else
                _zoo_state(name) if name in dict(ZOO_FAMILIES) else
                _np_state(_build(jmodels, name, **kw)))
    state = state_from_reference(np_state, "cpu", dtype="bfloat16")
    assert set(state) == set(np_state)
    port = _build(pmodels, name, device="cpu", **kw).to(torch.bfloat16)
    port.load_state_dict(state)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.float().numpy(), np_state[k], rtol=1e-2,
                                   atol=1e-2, err_msg=k)


def test_converter_maps_a_grouped_bottleneck_state():
    """The ResNet map reads groups and width from the 3x3 convolutions'
    shapes: a grouped bottleneck state (ResNet-50's layout at groups 2,
    width 4; its keys are the reference's, as the tests above hold)
    carries across, and a changed group count does not."""
    port = _build(pmodels, "bottleneck", device="cpu")
    np_state = {k: v.numpy() for k, v in port.state_dict().items()}
    assert set(state_from_reference(np_state, "cpu")) == set(np_state)
    key = "layer2.1.conv2.weight"
    np_state[key] = np.zeros((16, 16, 3, 3), np.float32)
    with pytest.raises(ValueError):
        state_from_reference(np_state, "cpu")


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
@pytest.mark.parametrize("name,kw", [
    ("resnet18", dict(num_classes=10)),
    ("LeNet", dict(num_classes=10)),
] + ZOO_FAMILIES, ids=["resnet18", "lenet"] + [n for n, _ in ZOO_FAMILIES])
@pytest.mark.parametrize("fn", ["load", "state"])
def test_converter_rejects_bad_state(fn, name, kw, fault):
    if name in dict(ZOO_FAMILIES):
        np_state = dict(_zoo_state(name))
        # a batch norm's statistic, or AlexNet's and SqueezeNet's (which
        # have none) last convolution's bias
        key = next((k for k in np_state if k.endswith("._mean")), None) \
            or [k for k in np_state if k.endswith(".bias")][-1]
    else:
        np_state = dict(_reference_state(name))
        key = "layer1.0.bn1._mean" if name == "resnet18" \
            else "features.3.bias"
    if fault == "missing":
        del np_state[key]
    elif fault == "unexpected":
        np_state["extra.weight"] = np.zeros(3, np.float32)
    else:
        np_state[key] = np.zeros(np_state[key].shape[0] + 1, np.float32)
    err = ValueError if fault == "shape" else KeyError
    with pytest.raises(err):
        if fn == "load":
            load_reference_state(getattr(pmodels, name)(device="cpu", **kw),
                                 np_state)
        else:
            state_from_reference(np_state, "cpu")
