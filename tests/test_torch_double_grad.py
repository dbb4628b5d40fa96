"""Second-order gradients in the port against the JAX package's: the
cases of tests/test_double_grad_custom_vjp.py that need no `distributed`,
and a Hessian-vector product of llama_tiny's loss.

scaled_dot_product_attention's kernel branch is forced by monkeypatching
`_use_pallas`, on both sides at the reference's own test's shape: the reference
then runs its Pallas kernel in interpret mode and records its dense
higher-order forward; the port runs K1-K4's plain versions on the CPU
through `_FlashAttentionHigherOrder`, whose create_graph backward is the
dense forward's. Reference calls are traced under one jax.jit. Tolerances
are float32's: rtol 2e-4, atol 2e-5 (the reference's own test's), and
1e-4 of the largest value for the Hessian-vector product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor
from paddle_tpu.nn.functional import attention as ref_attn
from paddle_tpu.parallel.functional import functional_call
from paddle_tpu_torch.nn.functional import attention as port_attn
from paddle_tpu_torch.ops import flash_attention as fa
from torch_seq_parity import copy_weights, reference

RTOL, ATOL = 2e-4, 2e-5
HVP_RTOL = 1e-4


@pytest.fixture
def kernel_branch(monkeypatch):
    """sdpa's kernel branch in the port."""
    monkeypatch.setattr(port_attn, "_use_pallas", lambda *a, **kw: True)


@pytest.fixture
def bwd_calls(monkeypatch):
    """Counts the calls of `_flash_bwd_bhsd` (K3/K4, or their plain
    versions on the CPU)."""
    calls = [0]
    real = fa._flash_bwd_bhsd

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(fa, "_flash_bwd_bhsd", counted)
    return calls


def _qkv(seed, shape_q, shape_kv):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_q).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32))


def _ref_double_grad(q, k, v, causal):
    """The reference's out, dq and d/dq sum(dq^2), one jit."""
    def f(qa, ka, va):
        qt = RefTensor(qa, stop_gradient=False)
        out = paddle.nn.functional.scaled_dot_product_attention(
            qt, RefTensor(ka), RefTensor(va), is_causal=causal)
        (gq,) = paddle.grad([out.sum()], [qt], create_graph=True)
        (ggq,) = paddle.grad([(gq * gq).sum()], [qt])
        return out._data, gq._data, ggq._data
    return [np.asarray(a) for a in jax.jit(f)(q, k, v)]


def _port_double_grad(q, k, v, causal):
    qt = torch.as_tensor(q).requires_grad_(True)
    out = pt.nn.functional.scaled_dot_product_attention(
        qt, torch.as_tensor(k), torch.as_tensor(v), is_causal=causal)
    (gq,) = pt.grad([out.sum()], [qt], create_graph=True)
    (ggq,) = pt.grad([(gq * gq).sum()], [qt])
    return [t.detach().numpy() for t in (out, gq, ggq)]


# the reference test's shape, where the reference takes its kernel
# branch too (its Pallas kernel in interpret mode, with its dense
# higher-order forward), and a head dim that the kernels pad (48 -> 64),
# not causal, where it takes its dense path (its own test holds the two
# equal)
SHAPES = {"reference": ((1, 8, 2, 4), (1, 8, 2, 4), True, True),
          "padded_d": ((2, 6, 2, 48), (2, 6, 2, 48), False, False)}
# and GQA (4 query heads on 2), held to the port's dense path
DENSE_SHAPES = {"reference": ((1, 8, 2, 4), (1, 8, 2, 4), True),
                "gqa": ((1, 8, 4, 8), (1, 8, 2, 8), True),
                "padded_d": ((2, 6, 2, 48), (2, 6, 2, 48), False)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_branch_double_grad_matches_reference(name, kernel_branch,
                                                     bwd_calls,
                                                     monkeypatch):
    sq, skv, causal, ref_kernel = SHAPES[name]
    monkeypatch.setattr(ref_attn, "_use_pallas",
                        lambda *a, **kw: ref_kernel)
    q, k, v = _qkv(0, sq, skv)
    want = _ref_double_grad(q, k, v, causal)
    got = _port_double_grad(q, k, v, causal)
    for label, g, w in zip(("out", "dq", "ddq"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {label}")
    assert np.abs(want[2]).sum() > 0
    # the create_graph backward differentiates the dense forward: no
    # K3/K4 (nor their plain versions)
    assert bwd_calls[0] == 0


@pytest.mark.parametrize("name", sorted(DENSE_SHAPES))
def test_kernel_branch_matches_dense_path(name, kernel_branch, monkeypatch):
    sq, skv, causal = DENSE_SHAPES[name]
    q, k, v = _qkv(1, sq, skv)
    flash = _port_double_grad(q, k, v, causal)
    monkeypatch.setattr(port_attn, "_use_pallas", lambda *a, **kw: False)
    dense = _port_double_grad(q, k, v, causal)
    for g, w in zip(flash, dense):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_first_order_is_the_raw_wrapper_bit_for_bit(kernel_branch,
                                                    bwd_calls):
    """The higher-order Function changes neither the primal nor the first
    order: sdpa's kernel branch against flash_attention_bshd, exactly, with
    one backward through K3/K4's path each."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(2, (2, 16, 4, 32),
                                                   (2, 16, 2, 32)))
    outs, grads = [], []
    for f in (lambda *a: fa.flash_attention_bshd(*a, causal=True),
              lambda *a: pt.nn.functional.scaled_dot_product_attention(
                  *a, is_causal=True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = f(*leaves)
        out.pow(2).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert bwd_calls[0] == 2


def test_raw_wrapper_refuses_a_second_order_with_the_hint():
    q, k, v = (torch.as_tensor(a) for a in _qkv(3, (1, 8, 2, 4),
                                                   (1, 8, 2, 4)))
    q.requires_grad_(True)
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    w = torch.ones_like(out, requires_grad=True)
    (gq,) = torch.autograd.grad(out, q, w, create_graph=True)
    with pytest.raises(RuntimeError) as err:
        (gq * gq).sum().backward()
    assert "differentiate twice" in str(err.value)
    assert "FLAGS_flash_attention_backend" in str(err.value)


def test_fused_linear_double_grad():
    from paddle_tpu.incubate.nn import functional as JIF
    from paddle_tpu_torch.incubate.nn import functional as PIF
    rng = np.random.RandomState(0)
    x, w = rng.randn(4, 3).astype(np.float32), rng.randn(3, 5).astype(
        np.float32)
    b = np.zeros(5, np.float32)

    def run(P, F, T, leaf, arrs):
        xt, wt, bt = (leaf(T(a)) for a in arrs)
        y = F.fused_linear(xt, wt, bt)
        (gx,) = P.grad([(y * y).sum()], [xt], create_graph=True)
        return P.grad([(gx * gx).sum()], [xt, wt])

    want = jax.jit(lambda *a: [t._data for t in run(
        paddle, JIF, RefTensor, lambda t: (setattr(t, "stop_gradient",
                                                   False), t)[1], a)])(
        x, w, b)
    got = run(pt, PIF, torch.as_tensor, lambda t: t.requires_grad_(True),
              (x, w, b))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_pylayer_with_a_differentiable_backward():
    """The port's counterpart of the reference's custom_vjp cube: a
    backward in ordinary ops is differentiated again."""
    class Cube(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return 3.0 * x ** 2 * g

    x = torch.tensor([2.0], requires_grad=True)
    (gx,) = pt.grad([Cube.apply(x).sum()], [x], create_graph=True)
    (ggx,) = pt.grad([gx.sum()], [x])
    assert float(gx.detach()) == 12.0 and float(ggx) == 12.0


def test_transforms_through_the_kernel_branch(kernel_branch, monkeypatch):
    """vjp, jvp, jacobian and hessian run on the tape, so they take the
    flash Functions (torch.func would refuse them): the same numbers as
    the dense path's."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(4, (1, 4, 2, 4),
                                                   (1, 4, 2, 4)))

    def f(x):
        return pt.nn.functional.scaled_dot_product_attention(
            x, k, v, is_causal=True)

    def run():
        A = pt.autograd
        return [A.vjp(f, q)[1], A.jvp(f, q, torch.ones_like(q))[1],
                A.jacobian(f, q), A.hessian(lambda x: f(x).pow(2).sum(), q)]

    flash = run()
    monkeypatch.setattr(port_attn, "_use_pallas", lambda *a, **kw: False)
    for g, w in zip(flash, run()):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_llama_tiny_hessian_vector_product(kernel_branch):
    """Hv of llama_tiny's LM loss, the reference's weights carried across:
    the port's paddle.grad(create_graph=True) through sdpa's kernel branch
    against the reference's forward-over-reverse jax.jvp(jax.grad) through
    its dense path (its Pallas kernel has no jvp; the cases above hold its
    kernel branch to its dense one)."""
    ref = reference(paddle.models.llama_tiny)
    port = copy_weights(pt.models.llama_tiny(device="cpu"), ref)
    params = {k: t._data for k, t in ref.state_dict().items()}
    rng = np.random.RandomState(1)
    vec = {k: rng.randn(*a.shape).astype(np.float32)
           for k, a in sorted(params.items())}
    ids = np.random.RandomState(0).randint(0, 512, (2, 9))

    def loss(p):
        return functional_call(ref, p, jnp.asarray(ids, jnp.int32),
                               labels=jnp.asarray(ids, jnp.int32))[0]
    want = jax.jit(lambda p, t: jax.jvp(jax.grad(loss), (p,), (t,))[1])(
        params, {k: jnp.asarray(a) for k, a in vec.items()})

    named = dict(port.named_parameters())
    t_ids = torch.as_tensor(ids)
    loss_p, _ = port(t_ids, labels=t_ids)
    grads = pt.grad(loss_p, list(named.values()), create_graph=True)
    dot = sum((g * torch.as_tensor(vec[n])).sum()
              for n, g in zip(named, grads))
    hv = pt.grad(dot, list(named.values()))
    assert set(named) == set(params)
    for n, h in zip(named, hv):
        w = np.asarray(want[n])
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(h.numpy() / scale, w / scale, rtol=0,
                                   atol=HVP_RTOL, err_msg=n)
