"""The vision slice as a whole: chip_smoke.py's phase-21 models, written
once against a package `P`, built from the JAX package and from the port
at a small size, the reference's weights (drawn from numpy) copied into
the port key for key (`convert.load_reference_state`).

(a) The ViT at 2 layers, d64, 4 heads, 32 x 32 images in patches of 8, 10
classes: one DeiT training step (a mixup batch, label smoothing 0.1, a
soft-label cross-entropy; stochastic depth off, so its blocks hold
nn.Identity) with equal loss and gradients. (b) The DDPM U-Net at ch 32,
ch_mult (1, 2), one residual block a level, attention at 8 x 8, 16 x 16
images, dropout off: one training step (the epsilon MSE at given t and
noise) with equal loss and gradients, and one ancestral sampling step with
equal output. Loss and outputs at rtol 1e-5, atol 1e-5, gradients at
rtol 1e-4, atol 2e-5 (float32 sums over the batch and 16-256 positions in
other orders); the reference's through its jitted functional_call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor
from torch_seq_parity import assert_grads_close, copy_weights, ref_run, \
    reference
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=2e-5)
CLASSES = 10


@pytest.fixture
def on_cpu():
    prev = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


def _build(make):
    ref = reference(lambda: make(paddle))
    port = make(pt)
    assert list(port.state_dict()) == list(ref.state_dict())
    return copy_weights(port, ref), ref


def _step(port, ref, loss_fn, arrays):
    """loss_fn(P, model, *tensors)'s value and gradients: the port's by its
    backward, the reference's by jax.grad of its functional_call."""
    loss_p = loss_fn(pt, port, *[torch.tensor(a) for a in arrays])
    loss_p.backward()

    def calls(f):
        model = lambda *a: RefTensor(f(*a))
        return loss_fn(paddle, model, *[RefTensor(jnp.asarray(a))
                                        for a in arrays])._data

    loss_r, grads = ref_run(ref, calls, loss=lambda loss: loss)
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r), **TOL)
    assert_grads_close(port, grads, **GTOL)


def test_vit_deit_step(on_cpu):
    port, ref = _build(lambda P: cs.vit(P, 32, 8, 64, 2, 4, 128, CLASSES,
                                        0.0))
    assert isinstance(port.blocks[0].drop_path, pt.nn.Identity)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 4)
    perm = rng.permutation(4)
    lam = float(rng.beta(0.8, 0.8))

    def loss(P, model, x, y, p):
        return cs.vit_loss(P, model, x, y, p, lam, CLASSES, 0.1)

    _step(port, ref, loss, [images, labels, perm])


def test_vit_stochastic_depth_drops_whole_samples(on_cpu):
    """With drop_path, each block's branch is kept or dropped per sample in
    training, and the model is deterministic in eval."""
    pt.seed(0)
    model = cs.vit(pt, 16, 8, 32, 2, 2, 64, CLASSES, 0.5)
    dp = model.blocks[1].drop_path
    out = dp(torch.ones(64, 3, 4))
    per_sample = out.reshape(64, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 2).all(1)).all()
    assert 0 < int((per_sample == 0).all(1).sum()) < 64
    model.eval()
    x = torch.randn(2, 3, 16, 16)
    torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)


def _unet(P):
    return cs.ddpm_unet(P, 32, (1, 2), 1, (8,), 0.0, 16)


def _tables(P, sched, port):
    return {k: (torch.tensor(v) if port else RefTensor(jnp.asarray(v)))
            for k, v in sched.items()}


@pytest.fixture(scope="module")
def unet_pair():
    prev = pt.get_device()
    pt.set_device("cpu")
    pair = _build(_unet)
    pt.set_device(prev)
    return pair


def test_ddpm_training_step(unet_pair, on_cpu):
    port, ref = unet_pair
    port.clear_gradients()
    sched = cs.ddpm_schedule(1000, 1e-4, 0.02)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    t = np.array([3, 870])
    noise = rng.standard_normal(x0.shape).astype(np.float32)

    def loss(P, model, x, tt, n):
        return cs.ddpm_loss(P, model, x, tt, n,
                            _tables(P, sched, P is pt))

    _step(port, ref, loss, [x0, t, noise])


def test_ddpm_sampling_step(unet_pair, on_cpu):
    port, ref = unet_pair
    sched = cs.ddpm_schedule(1000, 1e-4, 0.02)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    z = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([999, 999])
    port.eval()
    with torch.no_grad():
        out_p = cs.ddpm_sample_step(pt, port, torch.tensor(x),
                                    torch.tensor(t), torch.tensor(z),
                                    _tables(pt, sched, True))

    def calls(f):
        model = lambda *a: RefTensor(f(*a))
        return cs.ddpm_sample_step(
            paddle, model, RefTensor(jnp.asarray(x)),
            RefTensor(jnp.asarray(t)), RefTensor(jnp.asarray(z)),
            _tables(paddle, sched, False))._data

    out_r, _ = ref_run(ref, calls, training=False)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)


def test_ddpm_unet_published_size():
    """ch 128, ch_mult (1, 2, 2, 2), 2 blocks a level, attention at 16 x 16
    on 32 x 32 images: Ho et al.'s 35.7M parameters, counted on the meta
    device."""
    with torch.device("meta"):
        prev = pt.get_device()
        pt.set_device("meta")
        try:
            model = cs.ddpm_unet(pt, 128, (1, 2, 2, 2), 2, (16,), 0.1, 32)
        finally:
            pt.set_device(prev)
    n = sum(p.numel() for p in model.parameters())
    assert 35.6e6 < n < 35.9e6, n
