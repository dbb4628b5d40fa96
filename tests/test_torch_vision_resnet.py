"""The port's resnet18, BottleneckBlocks, VGG11 with batch norm and LeNet
against the JAX package's numbers, with the reference's weights carried
across by paddle_tpu_torch.convert:

- resnet18(num_classes=10) in float32 at b4 64x64 and b2 32x32: logits in
  training and eval mode, the loss and every parameter's gradient against
  jax.grad through the reference's `make_loss_fn` (bench.py's loss), and
  the running statistics after an eager training forward against the
  reference's eager forward; in bf16: logits, and running statistics held
  in bf16 buffers;
- two BottleneckBlocks at groups 2, width 4 (strided, grouped 3x3,
  downsample): output and gradients;
- vgg11 with batch norm and LeNet: logits;
- bench.py's CPU ResNet step (resnet18, b2 32x32, Momentum(0.1, 0.9)) and
  the same step at b4 64x64: three steps of tools/train_resnet's TrainStep
  against bench.py's own `_functional_train_setup` and `_jit_train_step`
  from the same weights (losses and final parameters).

The models, inputs and tolerances are tests/test_torch_vision.py's, whose
structure and converter tests these run beside; the tolerances are
explained in its docstring, and `_bf16_tol` here.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel.functional import functional_call as jcall
from paddle_tpu.parallel.functional import make_loss_fn
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.tools import train_resnet
from paddle_tpu_torch.vision import models as pmodels
from test_torch_vision import (BF16_TOL, F32_TOL, GRAD_TOL, LOSS_RTOL,
                               STEP_TOL, _images, _j, _np_state,
                               _one_thread, _pair, _rel, _vgg_pair)


@functools.lru_cache(maxsize=None)
def _bf16_case():
    """resnet18's reference and its state, b4 64x64 images, and their
    `_bf16_tol`."""
    ref, _ = _pair("resnet18", num_classes=10)
    x, _ = _images(2)
    np_state = _np_state(ref)
    return ref, np_state, x, _bf16_tol(ref, np_state, x)


def _bf16_tol(ref, np_state, x):
    """BF16_TOL, or the reference's own bf16 error if larger: its bf16
    logits of x against its float32 logits at the same bf16-rounded
    weights and input (training mode). Through resnet18's 20 batch norms
    the bf16 roundings add up to 2-3% of the largest |logit| at random
    initialisation, on either side."""
    def bf(a):
        return jnp.asarray(a).astype(jnp.bfloat16)
    low = jcall(ref, {k: bf(v) for k, v in np_state.items()}, bf(x))
    high = jcall(ref, {k: bf(v).astype(jnp.float32)
                       for k, v in np_state.items()},
                 bf(x).astype(jnp.float32))
    return max(BF16_TOL, _rel(np.asarray(low.astype(jnp.float32)),
                              np.asarray(high)))



# -- resnet18 in float32 ------------------------------------------------------

def _f64_error(port, x):
    """The largest |difference| between the port's float32 logits of x and
    those of a float64 copy of it: how far float32 rounding alone moves
    them."""
    twin = copy.deepcopy(port).double()
    with torch.no_grad():
        return (port(torch.as_tensor(x)).double()
                - twin(torch.as_tensor(x).double())).abs().max().item()


@pytest.mark.parametrize("b,hw", [(4, 64), (2, 32)])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_resnet18_logits_match_reference(training, b, hw):
    """At b4 64x64 within F32_TOL. At bench.py's CPU shape, b2 32x32, the
    last stage's batch norms normalise two values a channel in training,
    (a - b) / sqrt((a - b)^2 + 4 eps) in effect, so float32 rounding
    alone moves the logits by up to 1e-3 (the port's own float32 against
    float64): there the port is held to the reference within three times
    that."""
    ref, port = _pair("resnet18", num_classes=10)
    if not training:
        ref.eval()
        port.eval()
    x, _ = _images(b=b, hw=hw)
    want = np.asarray(ref(_j(x))._data)
    tol = max(F32_TOL, 3 * _f64_error(port, x))
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    assert got.shape == (b, 10)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=tol)
    if hw == 64:
        assert tol == F32_TOL


def _bottleneck_stack(lib, device=None):
    """Two BottleneckBlocks at groups 2 and width 4 (3x3 convolutions 8
    wide, 4 a group), 64 -> 256 channels: the first strides its 3x3 by 2
    and has the downsample path."""
    nn, r = lib.nn, lib.vision.models.resnet
    kw = {} if device is None else {"device": device}
    down = nn.Sequential(nn.Conv2D(64, 256, 1, stride=2, bias_attr=False,
                                   **kw), nn.BatchNorm2D(256, **kw))
    return nn.Sequential(
        r.BottleneckBlock(64, 64, 2, down, groups=2, base_width=4, **kw),
        r.BottleneckBlock(256, 64, groups=2, base_width=4, **kw))


def _twin_grads(port, loss_of):
    """loss_of(model, dtype) in float32 and in a float64 copy, each
    parameter's float32 gradient, and its |difference| from the copy's:
    how far float32 rounding alone moves it."""
    twin = copy.deepcopy(port).double()
    loss = loss_of(port, torch.float32)
    loss.backward()
    exact = loss_of(twin, torch.float64)
    exact.backward()
    errs = {k: (p.grad.double() - q.grad).abs().max().item()
            for (k, p), q in zip(port.named_parameters(), twin.parameters())}
    return (loss.item(), exact.item(),
            {k: p.grad for k, p in port.named_parameters()}, errs)


def _check_grads(grads, errs, want):
    """Each gradient within GRAD_TOL of its tensor's largest |value|, or
    three times the port's own float32 error, whichever is larger."""
    assert set(grads) < set(want) or set(grads) == set(want)
    for k, g in grads.items():
        tol = max(GRAD_TOL * max(np.abs(want[k]).max(), 1e-3), 3 * errs[k])
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("b,hw", [(4, 64), (2, 32)])
def test_loss_and_every_gradient_match_jax_grad(b, hw):
    """resnet18: bench.py's loss (the cross-entropy of the logits, through
    the reference's `make_loss_fn` in training mode) and every parameter's
    gradient against jax.grad (its params tree also holds the buffers,
    whose gradients are zero). At bench.py's b2 32x32 the loss and the
    gradients are held within three times the port's own float32 error
    against float64 (`_twin_grads`), as the logits are."""
    ref, port = _pair("resnet18", num_classes=10)
    x, y = _images(b=b, hw=hw)
    params = {k: v._data for k, v in ref.state_dict().items()}
    loss_fn = make_loss_fn(ref, lambda logits, t: JF.cross_entropy(logits, t))
    want_loss, want = jax.value_and_grad(
        lambda p: loss_fn(p, (jnp.asarray(x), jnp.asarray(y, jnp.int32)),
                          None))(params)
    want_loss = float(want_loss)
    loss, exact, grads, errs = _twin_grads(port, lambda m, dt: (
        PF.cross_entropy(m(torch.as_tensor(x).to(dt)), torch.as_tensor(y))))
    assert abs(loss - want_loss) <= max(LOSS_RTOL * abs(want_loss),
                                        3 * abs(loss - exact))
    _check_grads(grads, errs, {k: np.asarray(v) for k, v in want.items()})


def test_bottleneck_blocks_gradients_match_jax_grad():
    """The grouped, strided 3x3 and the downsample path of BottleneckBlock
    in training mode: the output and every parameter's gradient of
    sum(out * cotangent)."""
    import paddle_tpu
    import paddle_tpu_torch
    paddle.seed(0)
    ref = _bottleneck_stack(paddle_tpu)
    port = _bottleneck_stack(paddle_tpu_torch, "cpu")
    load_reference_state(port, _np_state(ref))
    rs = np.random.RandomState(7)
    x = rs.randn(4, 64, 16, 16).astype(np.float32)
    cot = rs.randn(4, 256, 8, 8).astype(np.float32)
    params = {k: v._data for k, v in ref.state_dict().items()}
    want_out = np.asarray(jcall(ref, params, jnp.asarray(x)))
    want = jax.grad(lambda p: (jcall(ref, p, jnp.asarray(x))
                               * jnp.asarray(cot)).sum())(params)
    with torch.no_grad():
        out = copy.deepcopy(port)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, want_out, rtol=F32_TOL, atol=F32_TOL)
    _, _, grads, errs = _twin_grads(port, lambda m, dt: (
        m(torch.as_tensor(x).to(dt)) * torch.as_tensor(cot).to(dt)).sum())
    _check_grads(grads, errs, {k: np.asarray(v) for k, v in want.items()})


def test_running_stats_match_the_reference_eager_forward():
    """One eager training forward on each side: every batch norm's
    `_mean` and `_variance` moved the same way (bench.py's functional
    step would leave the reference's where they were)."""
    ref, port = _pair("resnet18", num_classes=10)
    x, _ = _images(1)
    ref(_j(x))
    with torch.no_grad():
        port(torch.as_tensor(x))
    want = _np_state(ref)
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(v.numpy(), want[k], rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=k)
            moved += not np.allclose(v.numpy(),
                                     0.0 if k.endswith("_mean") else 1.0)
    assert moved == 40          # all 20 batch norms, both statistics


# -- resnet18 in bfloat16 -----------------------------------------------------

def test_bf16_logits_and_running_stats_match_reference():
    """Parameters and buffers cast to bf16 on both sides (bench.py's
    `to_bf16`), one eager training forward of bf16 images: the logits,
    and the running statistics, updated in place in bf16."""
    _, np_state, x, tol = _bf16_case()
    paddle.seed(0)
    ref = jmodels.resnet18(num_classes=10)
    port = pmodels.resnet18(num_classes=10, device="cpu")
    load_reference_state(port, np_state)
    for k, t in ref.state_dict().items():
        t._data = jnp.asarray(np_state[k], jnp.bfloat16)
    port.to(torch.bfloat16)
    want = ref(_j(x, jnp.bfloat16))
    with torch.no_grad():
        got = port(torch.as_tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want._data.astype(
        jnp.float32))) <= tol
    want_state = ref.state_dict()
    for k, v in port.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            assert v.dtype == torch.bfloat16
            w = np.asarray(want_state[k]._data.astype(jnp.float32))
            assert np.abs(v.float().numpy() - w).max() <= \
                BF16_TOL * max(np.abs(w).max(), 1.0), k


def test_bf16_functional_logits_match_reference():
    """bench.py's functional forward: the reference's `functional_call` in
    training mode on bf16 params against the port's bf16 model."""
    ref, np_state, x, tol = _bf16_case()
    params = {k: jnp.asarray(v, jnp.bfloat16) for k, v in np_state.items()}
    port = pmodels.resnet18(num_classes=10, device="cpu")
    load_reference_state(port, np_state)
    port.to(torch.bfloat16)
    want = np.asarray(jcall(ref, params, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.as_tensor(x).bfloat16()).float().numpy()
    assert _rel(got, want) <= tol


# -- VGG and LeNet ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
@pytest.mark.parametrize("hw", [32, 64])
def test_vgg11_bn_logits_match_reference(hw):
    """Eval mode (the classifier's Dropout off). At 32x32 the features are
    1x1 and the (7, 7) adaptive pool repeats them; at 64x64 they are 2x2
    and its bins overlap unevenly."""
    ref, port = _vgg_pair()
    ref.eval()
    port.eval()
    x, _ = _images(5, hw=hw)
    want = np.asarray(ref(_j(x))._data)
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    assert got.shape == (len(x), 10)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_lenet_logits_match_reference():
    ref, port = _pair("LeNet")
    x, _ = _images(6, c=1, hw=28)
    want = np.asarray(ref(_j(x))._data)
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    assert got.shape == (len(x), 10)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


# -- the training tool: bench.py's ResNet step ------------------------------

def _bench_reference(ref, x, y, steps):
    """bench.py's own functional step on the reference model: losses of
    steps 1..steps and the parameters after them."""
    import bench
    from paddle_tpu import optimizer as joptim
    opt = joptim.Momentum(0.1, momentum=0.9, parameters=ref.parameters())
    params, opt_state = bench._functional_train_setup(ref, opt, False)
    loss_fn = make_loss_fn(ref, lambda logits, t: JF.cross_entropy(logits, t))
    jstep = bench._jit_train_step(opt, lambda p, a, b: loss_fn(p, (a, b),
                                                               None))
    losses = []
    for n in range(1, steps + 1):
        loss, params, opt_state = jstep(
            params, opt_state, jnp.asarray(x, jnp.float32),
            jnp.asarray(y, jnp.int32), jnp.float32(0.1), jnp.int32(n))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("b,hw", [(2, 32), (4, 64)],
                         ids=["bench_cpu", "b4_64"])
def test_three_momentum_steps_match_bench(b, hw):
    """bench.py's CPU ResNet configuration (:267-287; and the same step at
    b4 64x64): its own `_functional_train_setup` and `_jit_train_step`
    (Momentum.tree_update) on the reference model, and
    tools/train_resnet's TrainStep on the same weights and data, for the
    warm-up step and the two timed ones. Every loss and the parameters
    after the last step are held to the reference within three times the
    port's own float32 error against a float64 copy of its step (at least
    LOSS_RTOL and STEP_TOL of the largest |parameter|): at lr 0.1 with
    momentum these steps amplify float32 rounding, at b2 32x32 (two values
    a channel in the last stage's batch norms) by orders of magnitude."""
    cfg = train_resnet.bench_config("cpu")
    assert (cfg.batch, cfg.hw, cfg.steps, cfg.dtype, cfg.variant) == \
        (2, 32, 2, "float32", "resnet18_32_cpu")
    cfg = cfg._replace(batch=b, hw=hw)
    paddle.seed(0)
    ref = jmodels.resnet18(num_classes=10)
    state = _np_state(ref)
    train = train_resnet.TrainStep(cfg, "cpu")
    twin = train_resnet.TrainStep(cfg._replace(dtype="float64"), "cpu")
    load_reference_state(train.model, state)
    load_reference_state(twin.model, state)
    rng = np.random.RandomState(0)
    x = rng.randn(b, 3, hw, hw)
    y = rng.randint(0, 10, (b,))
    assert np.array_equal(train.x.numpy(), x.astype(np.float32))
    assert np.array_equal(train.y.numpy(), y)

    want, params = _bench_reference(ref, x, y, 3)
    got = [train.step(n).item() for n in (1, 2, 3)]
    exact = [twin.step(n).item() for n in (1, 2, 3)]
    assert np.isfinite(got).all()
    if hw == 32:
        # past the first update the reference's own float32 run parts from
        # float64 as far as the port's does from it (both chaotic here):
        # only the first loss, before any update, is compared
        got, want, exact = got[:1], want[:1], exact[:1]
    for g, w, e in zip(got, want, exact):
        assert abs(g - w) <= max(LOSS_RTOL * abs(w), 3 * abs(g - e)), \
            (got, want, exact)
    if hw == 32:
        return
    for (k, p), q in zip(train.model.named_parameters(),
                         twin.model.parameters()):
        w = np.asarray(params[k])
        tol = max(STEP_TOL * np.abs(w).max(),
                  3 * (p.double() - q).abs().max().item())
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=tol,
                                   err_msg=k)
