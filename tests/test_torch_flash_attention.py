"""The port's flash-attention forward (K1) against the JAX package's.

paddle_tpu_torch.ops.flash_attention runs its plain torch version for CPU
tensors; the reference's Pallas kernel runs in interpret mode, as its own
tests run it (tests/test_flash_attention.py). Inputs are made with numpy
from a seed and handed to both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import flash_attention as fa
from torch_one_thread import one_torch_thread  # noqa: F401

# the reference kernel's own cases and tolerance
# (tests/test_flash_attention.py:41, :64), and the port kernel's tile edges
CASES = [
    (256, 256, False),
    (256, 256, True),
    (200, 200, True),
    (384, 384, True),
    (520, 520, True),
    (128, 320, True),
    (100, 260, False),
    # the edges of the H100 kernel's 128-row block and 128-key ring tiles
    (64, 64, True),
    (127, 127, True),
    (129, 129, True),
    (1, 300, False),
    (130, 1000, True),
]
F32_TOL = 2e-5
# bf16: P is rounded to bf16 at different places (the reference kernel
# rounds the unnormalized block P, the plain version the normalized one)
BF16_ATOL = 2e-2


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("sq,sk,causal", CASES)
def test_plain_matches_pallas_forward(sq, sk, causal):
    rs = np.random.RandomState(0)
    q, k, v = _rand(rs, 2, sq, 64), _rand(rs, 2, sk, 64), _rand(rs, 2, sk, 64)
    ref_out, ref_lse = jfa._flash_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 0.125,
        interpret=True)
    out, lse = fa._flash_fwd_bhsd(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), causal, 0.125)
    assert out.dtype == torch.float32 and lse.shape == (2, sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=F32_TOL, atol=F32_TOL)
    # the reference's lse keeps its block padding of the rows
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :sq],
                               rtol=F32_TOL, atol=F32_TOL)


def test_rows_without_keys_stay_finite():
    # causal sq > sk: the first sq - sk rows admit no key, so their values
    # are undefined; they must stay finite, and the rows that have keys
    # must match the reference
    sq, sk = 300, 100
    rs = np.random.RandomState(4)
    q, k, v = _rand(rs, 2, sq, 64), _rand(rs, 2, sk, 64), _rand(rs, 2, sk, 64)
    ref_out, ref_lse = jfa._flash_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 0.125,
        interpret=True)
    out, lse = fa._flash_fwd_bhsd(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), True, 0.125)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    live = slice(sq - sk, sq)
    np.testing.assert_allclose(out.numpy()[:, live],
                               np.asarray(ref_out)[:, live],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy()[:, live],
                               np.asarray(ref_lse)[:, live],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("h,kvh,d,causal", [
    (4, 2, 64, True),     # GQA
    (4, 2, 64, False),
    (4, 4, 96, True),     # head dim zero-padded to 128
    (4, 2, 96, True),
    (4, 2, 32, True),     # padded to 64 here, to 128 in the reference
    (8, 1, 64, True),     # GQA 8:1
])
def test_bshd_matches_reference(h, kvh, d, causal):
    rs = np.random.RandomState(3)
    q = _rand(rs, 2, 96, h, d)
    k, v = _rand(rs, 2, 96, kvh, d), _rand(rs, 2, 96, kvh, d)
    ref = jfa.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    out = fa.flash_attention_bshd(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), causal=causal)
    assert out.shape == (2, 96, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("d", [160, 256])
def test_head_dim_above_128_matches_reference(d):
    """Head dims the kernels do not take run on the CPU's plain path, as
    the reference pads them to a multiple of 128 and takes any d."""
    rs = np.random.RandomState(6)
    q = _rand(rs, 1, 40, 4, d)
    k, v = _rand(rs, 1, 40, 2, d), _rand(rs, 1, 40, 2, d)
    ref = jfa.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True)
    out = fa.flash_attention_bshd(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), causal=True)
    assert out.shape == (1, 40, 4, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_bf16_matches_reference():
    rs = np.random.RandomState(2)
    q = _rand(rs, 2, 128, 4, 64)
    k, v = _rand(rs, 2, 128, 2, 64), _rand(rs, 2, 128, 2, 64)
    ref = jfa.flash_attention_bshd(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True)
    out = fa.flash_attention_bshd(
        *(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=0)


def test_cpu_tensors_do_not_launch_the_kernel():
    assert fa.flash_fwd_launches == 0
    x = torch.randn(1, 64, 2, 64)
    fa.flash_attention_bshd(x, x, x, causal=True)
    fa._flash_fwd_bhsd(x[0].transpose(0, 1).contiguous(),
                       x[0].transpose(0, 1).contiguous(),
                       x[0].transpose(0, 1).contiguous(), False, 0.1)
    assert fa.flash_fwd_launches == 0


@pytest.mark.parametrize("bad", ["grad", "head_dim", "heads", "dtype",
                                 "shape"])
def test_wrapper_raises(bad):
    q = torch.randn(1, 16, 4, 64)
    k = v = torch.randn(1, 16, 2, 64)
    if bad == "grad":
        # first-order gradients flow (K3/K4); a second order raises
        q.requires_grad_(True)
        out = fa.flash_attention_bshd(q, k, v)
        w = torch.ones_like(out, requires_grad=True)
        (dq,) = torch.autograd.grad(out, q, w, create_graph=True)
        assert dq.shape == q.shape and torch.isfinite(dq).all()
        with pytest.raises(RuntimeError, match="differentiate twice"):
            dq.sum().backward()
    elif bad == "head_dim":
        # the plain path takes any head dim; the kernels' own check refuses
        # one above 128 on the card, where flash_attention_bshd takes the
        # dense path instead
        x = torch.randn(1, 16, 2, 160)
        assert fa.flash_attention_bshd(x, x, x).shape == x.shape
        xb = x[0].transpose(0, 1).contiguous().to(torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            fa._check_kernel_inputs("flash_fwd", (xb, xb, xb), 160)
    elif bad == "heads":
        with pytest.raises(ValueError, match="divisible"):
            fa.flash_attention_bshd(q, torch.randn(1, 16, 3, 64),
                                    torch.randn(1, 16, 3, 64))
    elif bad == "dtype":
        with pytest.raises(TypeError, match="dtype"):
            fa._flash_fwd_bhsd(torch.randn(2, 16, 64),
                               torch.randn(2, 16, 64).double(),
                               torch.randn(2, 16, 64), False, 0.1)
    else:
        with pytest.raises(ValueError, match="bad shapes"):
            fa._flash_fwd_bhsd(torch.randn(4, 16, 64), torch.randn(3, 16, 64),
                               torch.randn(3, 16, 64), False, 0.1, 2)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_matches_reference(masked):
    """nn.functional.scaled_dot_product_attention: the flash path without a
    mask, the dense path with an additive mask."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF
    rs = np.random.RandomState(4)
    q = _rand(rs, 2, 32, 4, 16)
    k, v = _rand(rs, 2, 32, 2, 16), _rand(rs, 2, 32, 2, 16)
    bias = (_rand(rs, 2, 1, 32, 32) if masked else None)
    ref = JF.scaled_dot_product_attention(
        paddle.Tensor(jnp.asarray(q)), paddle.Tensor(jnp.asarray(k)),
        paddle.Tensor(jnp.asarray(v)),
        attn_mask=None if bias is None else paddle.Tensor(jnp.asarray(bias)),
        is_causal=True)
    out = PF.scaled_dot_product_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        attn_mask=None if bias is None else torch.as_tensor(bias),
        is_causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._data),
                               rtol=F32_TOL, atol=F32_TOL)
