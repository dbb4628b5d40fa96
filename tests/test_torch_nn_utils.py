"""The port's nn.utils (nn/utils/__init__.py) against the reference's
(paddle_tpu/nn/utils/__init__.py), with the reference's weights copied
in: parameters_to_vector and vector_to_parameters exactly, weight_norm
(dim 0, 1 and None) and remove_weight_norm, and spectral_norm with the
reference's u and v, outputs at rtol 1e-5, atol 1e-5."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.nn import utils as RU
from paddle_tpu_torch.nn import utils as PU
from torch_seq_parity import copy_weights, ref_np
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
X = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)


def _pair():
    ref = paddle.nn.Linear(4, 5)
    return copy_weights(pt.nn.Linear(4, 5, device="cpu"), ref), ref


def test_parameters_to_vector_and_back():
    port, ref = _pair()
    vp = PU.parameters_to_vector(port.parameters())
    vr = RU.parameters_to_vector(ref.parameters())
    np.testing.assert_array_equal(vp.detach().numpy(), ref_np(vr))
    PU.vector_to_parameters(vp * 2, port.parameters())
    RU.vector_to_parameters(vr * 2, ref.parameters())
    for (n, a), (_, b) in zip(port.named_parameters(),
                              ref.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), ref_np(b), n)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_and_removal(dim):
    port, ref = _pair()
    PU.weight_norm(port, dim=dim)
    RU.weight_norm(ref, dim=dim)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    for name in ("weight_g", "weight_v"):
        np.testing.assert_allclose(getattr(port, name).detach().numpy(),
                                   ref_np(getattr(ref, name)), **TOL)
    with torch.no_grad():
        port.weight_g.mul_(1.5)
    ref.weight_g.set_value(port.weight_g.detach().numpy())
    outp, outr = port(torch.tensor(X)), ref(paddle.to_tensor(X))
    np.testing.assert_allclose(outp.detach().numpy(), ref_np(outr), **TOL)
    outp.sum().backward()
    assert port.weight_g.grad is not None and port.weight_v.grad is not None
    PU.remove_weight_norm(port)
    RU.remove_weight_norm(ref)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    np.testing.assert_allclose(port.weight.detach().numpy(),
                               ref_np(ref.weight), **TOL)


def test_spectral_norm():
    port, ref = _pair()
    PU.spectral_norm(port, n_power_iterations=3)
    RU.spectral_norm(ref, n_power_iterations=3)
    for name in ("weight_u", "weight_v"):
        getattr(port.weight_sn, name).data.copy_(torch.tensor(
            ref_np(getattr(ref.weight_sn, name))))
    outp, outr = port(torch.tensor(X)), ref(paddle.to_tensor(X))
    np.testing.assert_allclose(outp.detach().numpy(), ref_np(outr), **TOL)


def test_spectral_norm_divides_by_the_largest_singular_value():
    """On a weight whose singular values are 5, 1, 0.5 and 0.1, ten power
    iterations leave the normalized weight's largest at 1 (the error
    shrinks by (1/5)^2 an iteration)."""
    u, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((4, 4)))
    v, _ = np.linalg.qr(np.random.default_rng(2).standard_normal((5, 5)))
    w = (u @ np.diag([5.0, 1.0, 0.5, 0.1]) @ v[:4]).astype(np.float32)
    lin = pt.nn.Linear(4, 5, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w))
    PU.spectral_norm(lin, n_power_iterations=10, dim=1)
    lin(torch.tensor(X))
    got = np.linalg.svd(lin.weight.detach().numpy(), compute_uv=False)
    np.testing.assert_allclose(got, [1.0, 0.2, 0.1, 0.02], rtol=1e-4)
