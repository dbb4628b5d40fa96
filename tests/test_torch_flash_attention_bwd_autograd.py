"""The port's flash-attention backward (K3/K4) with GQA, in bf16 and
above head dim 128, its autograd Function against jax.grad, and the
wrapper's checks, against the JAX package's. The reference's Pallas
backward runs in interpret mode, as its own tests run it; the inputs,
helpers and tolerances are tests/test_torch_flash_attention_bwd.py's,
whose reference compiles these run beside.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from test_torch_flash_attention_bwd import (BF16_RTOL, F32_TOL, _port_bwd,
                                            _rand, _ref_bwd)
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("sq", [64, 100])   # 100: ragged tail
def test_gqa_backward_matches_reference(sq):
    """The reference's GQA test (tests/test_flash_attention.py:296): dk/dv
    come back summed over the query-head group, against the Pallas kernel
    and against jax.grad of dense attention over expanded kv."""
    r = np.random.RandomState(7)
    b, h, kvh, d, rep = 2, 4, 2, 16, 2
    q = r.randn(b * h, sq, d).astype(np.float32)
    k = r.randn(b * kvh, sq, d).astype(np.float32)
    v = r.randn(b * kvh, sq, d).astype(np.float32)
    g = np.ones_like(q)
    got = _port_bwd(q, k, v, g, True, 0.25, rep)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    want = _ref_bwd(q, k, v, g, True, 0.25, rep, block_q=32, block_k=32)

    def expand(x):
        return jnp.repeat(x.reshape(b * kvh, 1, sq, d), rep, 1).reshape(
            b * h, sq, d)

    def dense_loss(q_, k_, v_):
        return jfa._xla_attention_bhsd(q_, expand(k_), expand(v_), True,
                                       0.25).sum()
    dense = jax.grad(dense_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for x, w, dn, name in zip(got, want, dense, ("dq", "dk", "dv")):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)
        # the reference's own tolerance against dense attention
        np.testing.assert_allclose(x.numpy(), np.asarray(dn), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def test_bf16_backward_matches_reference():
    rs = np.random.RandomState(2)
    q, k, v, g = (_rand(rs, 4, 128, 64) for _ in range(4))
    q16, k16, v16, g16 = (torch.as_tensor(x).to(torch.bfloat16)
                          for x in (q, k, v, g))
    out, lse = fa._flash_fwd_bhsd(q16, k16, v16, True, 0.125)
    got = fa._flash_bwd_bhsd(q16, k16, v16, out, lse, g16, True, 0.125)
    want = _ref_bwd(*(jnp.asarray(x).astype(jnp.bfloat16)
                      for x in (q, k, v, g)), True, 0.125)
    for x, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == torch.bfloat16, name
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(x.float().numpy() - w).max() / np.abs(w).max()
        assert err <= BF16_RTOL, (name, err)


@pytest.mark.parametrize("h,kvh,d", [
    (4, 4, 64),
    (4, 4, 96),    # head dim zero-padded to 128; pad grads sliced off
    (4, 2, 64),    # GQA 4/2
])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad(h, kvh, d, causal):
    """torch.autograd through flash_attention_bshd against jax.grad of the
    reference's flash_attention_bshd (its custom_vjp backward)."""
    rs = np.random.RandomState(5)
    q = _rand(rs, 2, 80, h, d)
    k, v = _rand(rs, 2, 80, kvh, d), _rand(rs, 2, 80, kvh, d)
    w = _rand(rs, 2, 80, h, d)

    def ref_loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention_bshd(q_, k_, v_, causal=causal)
                       * jnp.asarray(w))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention_bshd(qt, kt, vt, causal=causal)
    (out * torch.as_tensor(w)).sum().backward()
    for x, wg, name in zip((qt, kt, vt), want, ("dq", "dk", "dv")):
        assert x.grad.shape == x.shape, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wg),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)


@pytest.mark.parametrize("d", [160, 256])
def test_head_dim_above_128_backward_matches_reference(d):
    """Head dims the kernels do not take: autograd through the CPU's plain
    path against jax.grad of the reference, which pads d to a multiple of
    128."""
    rs = np.random.RandomState(7)
    q = _rand(rs, 1, 40, 4, d)
    k, v = _rand(rs, 1, 40, 2, d), _rand(rs, 1, 40, 2, d)
    w = _rand(rs, 1, 40, 4, d)

    def ref_loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention_bshd(q_, k_, v_, causal=True)
                       * jnp.asarray(w))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention_bshd(qt, kt, vt, causal=True)
    (out * torch.as_tensor(w)).sum().backward()
    for x, wg, name in zip((qt, kt, vt), want, ("dq", "dk", "dv")):
        assert x.grad.shape == x.shape, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wg),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def test_cpu_tensors_do_not_launch_the_backward_kernels():
    before = (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    x = torch.randn(1, 64, 2, 64, requires_grad=True)
    fa.flash_attention_bshd(x, x, x, causal=True).sum().backward()
    assert x.grad is not None
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_backward_wrapper_raises(bad):
    q = torch.randn(4, 16, 64)
    k = v = torch.randn(2, 16, 64)
    out, lse = fa._flash_fwd_bhsd(q, k, v, True, 0.1, 2)
    g = torch.randn_like(q)
    if bad == "shape":
        with pytest.raises(ValueError, match="bad shapes"):
            fa._flash_bwd_bhsd(q, k, v, out, lse[:, :8], g, True, 0.1, 2)
    elif bad == "dtype":
        with pytest.raises(TypeError, match="dtype"):
            fa._flash_bwd_bhsd(q, k, v, out, lse, g.double(), True, 0.1, 2)
    else:
        with pytest.raises(ValueError, match="does not run on"):
            fa._flash_bwd_bhsd(*(t.to("meta") for t in (q, k, v, out, lse,
                                                         g)), True, 0.1, 2)
