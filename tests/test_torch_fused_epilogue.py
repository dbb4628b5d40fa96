"""The port's fused attention-RMSNorm epilogue (K2) and its incubate entry
point against the JAX package's.

paddle_tpu_torch.ops.flash_attention runs K2's plain torch version for CPU
tensors; the reference's Pallas kernel (`_fa_fwd_kernel` with
epilogue=True) runs in interpret mode, as its own tests run it
(tests/test_attention_router.py::TestFusedEpilogue). Inputs are made with
numpy from a seed and handed to both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.framework import random as pt_random
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops import attention_router as ar
from paddle_tpu_torch.ops import flash_attention as fa
from torch_one_thread import one_torch_thread  # noqa: F401

# f32 on both sides: the reference's own tolerance for the fused epilogue
# (tests/test_attention_router.py:294)
F32_TOL = 2e-5
# bf16: the attention output agrees within K1's bf16 tolerance (P is
# rounded to bf16 at different places, tests/test_torch_flash_attention.py)
# and the epilogue scales it by rsqrt(mean(h^2)) * gamma, about |gamma|;
# the output is then rounded to bf16 (a relative step of 2^-8)
BF16_ATOL = 2e-2
BF16_RTOL = 2e-2
EPS = 1e-6


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("d", [32, 48])   # 48: zero-padded head dim
def test_bshd_matches_reference_padded(d):
    """The reference's TestFusedEpilogue case (:280-295): the fused
    epilogue against the reference's kernel and its unfused composition,
    at head dims padded to the kernels' sizes (the mean over the true d)."""
    rs = np.random.RandomState(3)
    b, s, h = 1, 200, 2
    q, k, v, res = (_rand(rs, b, s, h, d) for _ in range(4))
    w = _rand(rs, d)
    want = jfa.flash_attention_rms_epilogue_bshd(_j(q), _j(k), _j(v),
                                                 _j(res), _j(w))
    att = jfa.flash_attention_bshd(_j(q), _j(k), _j(v), causal=True)
    hh = att + _j(res)
    unfused = hh * jax.lax.rsqrt(
        jnp.mean(hh * hh, axis=-1, keepdims=True) + EPS) * _j(w)
    got = fa.flash_attention_rms_epilogue_bshd(
        *(torch.as_tensor(x) for x in (q, k, v, res, w)))
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    for ref in (want, unfused):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("sq,sk,d,h,kvh", [
    (256, 256, 64, 2, 2),
    (256, 256, 128, 2, 2),
    (200, 200, 64, 2, 2),     # ragged tail
    (520, 520, 64, 2, 2),     # ragged, more than one 128-row block
    (128, 320, 64, 2, 2),     # sq != sk, bottom-right causal
    (256, 256, 64, 4, 2),     # GQA 4/2
])
def test_plain_epilogue_matches_pallas(sq, sk, d, h, kvh):
    """K2's plain version against the reference's `_flash_fwd_bhsd` with
    residual and rms_weight, in interpret mode: out and lse."""
    rs = np.random.RandomState(5)
    q = _rand(rs, h, sq, d)
    k, v = _rand(rs, kvh, sk, d), _rand(rs, kvh, sk, d)
    res, w = _rand(rs, h, sq, d), _rand(rs, d)
    ref_out, ref_lse = jfa._flash_fwd_bhsd(
        _j(q), _j(k), _j(v), True, d ** -0.5, interpret=True,
        q_per_kv=h // kvh, residual=_j(res), rms_weight=_j(w), rms_eps=EPS,
        rms_d=d)
    out, lse = fa._flash_fwd_bhsd(
        *(torch.as_tensor(x) for x in (q, k, v)), True, d ** -0.5,
        h // kvh, residual=torch.as_tensor(res),
        rms_weight=torch.as_tensor(w), rms_eps=EPS, rms_d=d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :sq],
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_epilogue_rms_d_is_the_true_head_dim():
    """With zero pad columns in q, k, v, the residual and gamma, the plain
    version's output over the true columns equals the unpadded call's, and
    its pad columns stay zero."""
    rs = np.random.RandomState(6)
    q, k, v, res = (torch.as_tensor(_rand(rs, 2, 64, 40)) for _ in range(4))
    w = torch.as_tensor(_rand(rs, 40))
    want, _ = fa._flash_fwd_bhsd(q, k, v, True, 40 ** -0.5, residual=res,
                                 rms_weight=w, rms_eps=EPS)
    pad = torch.nn.functional.pad
    got, _ = fa._flash_fwd_bhsd(*(pad(x, (0, 24)) for x in (q, k, v)), True,
                                40 ** -0.5, residual=pad(res, (0, 24)),
                                rms_weight=pad(w, (0, 24)), rms_eps=EPS,
                                rms_d=40)
    np.testing.assert_allclose(got[..., :40].numpy(), want.numpy(),
                               rtol=F32_TOL, atol=F32_TOL)
    assert not got[..., 40:].any()


def test_bf16_matches_reference():
    rs = np.random.RandomState(7)
    q, res = _rand(rs, 2, 128, 4, 64), _rand(rs, 2, 128, 4, 64)
    k, v = _rand(rs, 2, 128, 2, 64), _rand(rs, 2, 128, 2, 64)
    w = _rand(rs, 64)
    ref = jfa.flash_attention_rms_epilogue_bshd(
        *(_j(x).astype(jnp.bfloat16) for x in (q, k, v, res)), _j(w))
    got = fa.flash_attention_rms_epilogue_bshd(
        *(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v, res)),
        torch.as_tensor(w))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref)
    assert (err <= BF16_ATOL * np.abs(w).max()
            + BF16_RTOL * np.abs(ref)).all(), err.max()


def test_incubate_unfused_path_matches_reference():
    """The reference's incubate case (:297-313), GQA: on the CPU both run
    the unfused composition; each also agrees with the fused kernel run
    directly, within the reference's tolerance."""
    rs = np.random.RandomState(4)
    b, s, h, kvh, d = 1, 64, 4, 2, 16
    q, res = _rand(rs, b, s, h, d), _rand(rs, b, s, h, d)
    k, v = _rand(rs, b, s, kvh, d), _rand(rs, b, s, kvh, d)
    w = _rand(rs, d)
    ref = JIF.fused_attention_rms_epilogue(
        *(paddle.Tensor(_j(x)) for x in (q, k, v, res, w)))
    launched = fa.flash_fwd_rms_epilogue_launches
    got = IF.fused_attention_rms_epilogue(
        *(torch.as_tensor(x) for x in (q, k, v, res, w)))
    assert fa.flash_fwd_rms_epilogue_launches == launched
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref._data),
                               rtol=F32_TOL, atol=F32_TOL)
    fused = fa.flash_attention_rms_epilogue_bshd(
        *(torch.as_tensor(x) for x in (q, k, v, res, w)))
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_incubate_takes_the_composition_off_cuda(monkeypatch):
    """Even where the ledger marks the fusion a winner, CPU tensors take
    the unfused composition (the reference takes it off a TPU), which is
    differentiable."""
    monkeypatch.setattr(ar, "epilogue_fusion_wins", lambda *a, **k: True)
    rs = np.random.RandomState(8)
    q, k, v, res = (torch.tensor(_rand(rs, 1, 32, 2, 16), requires_grad=True)
                    for _ in range(4))
    w = torch.tensor(_rand(rs, 16), requires_grad=True)
    IF.fused_attention_rms_epilogue(q, k, v, res, w).sum().backward()
    assert all(x.grad is not None for x in (q, k, v, res, w))


def test_fused_epilogue_is_forward_only():
    x = torch.randn(1, 16, 2, 64, requires_grad=True)
    w = torch.randn(64)
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_attention_rms_epilogue_bshd(x, x, x, x, w)
    with torch.no_grad():
        out = fa.flash_attention_rms_epilogue_bshd(x, x, x, x, w)
    assert out.shape == x.shape


@pytest.mark.parametrize("bad", ["residual", "weight", "alone", "head_dim"])
def test_epilogue_wrapper_raises(bad):
    q = torch.randn(1, 16, 4, 64)
    kv = torch.randn(1, 16, 2, 64)
    if bad == "residual":
        with pytest.raises(ValueError, match="residual"):
            fa.flash_attention_rms_epilogue_bshd(q, kv, kv, kv,
                                                 torch.randn(64))
    elif bad == "weight":
        with pytest.raises(ValueError, match="rms_weight"):
            fa.flash_attention_rms_epilogue_bshd(q, kv, kv, q,
                                                 torch.randn(32))
    elif bad == "alone":
        x = torch.randn(2, 16, 64)
        with pytest.raises(ValueError, match="together"):
            fa._flash_fwd_bhsd(x, x, x, True, 0.1, residual=x)
    else:
        # the plain path takes a head dim above 128, as the reference
        # takes any d; the kernel's own check refuses it on the card, where
        # the wrapper takes the dense math instead
        rs = np.random.RandomState(11)
        x, w = _rand(rs, 1, 16, 2, 160), _rand(rs, 160)
        want = jfa.flash_attention_rms_epilogue_bshd(_j(x), _j(x), _j(x),
                                                     _j(x), _j(w))
        got = fa.flash_attention_rms_epilogue_bshd(
            *(torch.as_tensor(t) for t in (x, x, x, x, w)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
        xb = torch.as_tensor(x[0]).to(torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            fa._check_kernel_inputs("flash_fwd_rms_epilogue", (xb,), 160)


@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_rms_norm_matches_reference(with_residual):
    rs = np.random.RandomState(9)
    x, r = _rand(rs, 2, 8, 32), _rand(rs, 2, 8, 32)
    bias, w = _rand(rs, 32), _rand(rs, 32)
    kw = dict(residual=r, bias=bias) if with_residual else {}
    ref = JIF.fused_rms_norm(paddle.Tensor(_j(x)), paddle.Tensor(_j(w)),
                             **{k: paddle.Tensor(_j(v))
                                for k, v in kw.items()})
    got = IF.fused_rms_norm(torch.as_tensor(x), torch.as_tensor(w),
                            **{k: torch.as_tensor(v) for k, v in kw.items()})
    refs = ref if with_residual else (ref,)
    gots = got if with_residual else (got,)
    assert len(gots) == len(refs)
    for g, rf in zip(gots, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(rf._data),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_fused_dot_product_attention_matches_reference():
    rs = np.random.RandomState(10)
    q = _rand(rs, 2, 32, 4, 16)
    k, v = _rand(rs, 2, 32, 2, 16), _rand(rs, 2, 32, 2, 16)
    ref = JIF.fused_dot_product_attention(
        *(paddle.Tensor(_j(x)) for x in (q, k, v)), is_causal=True)
    got = IF.fused_dot_product_attention(
        *(torch.as_tensor(x) for x in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref._data),
                               rtol=F32_TOL, atol=F32_TOL)
    # attention dropout is passed on, as the reference passes it: without
    # training it is no dropout
    T = [torch.as_tensor(x) for x in (q, k, v)]
    ref = JIF.fused_dot_product_attention(
        *(paddle.Tensor(_j(x)) for x in (q, k, v)), dropout_p=0.5,
        is_causal=True, training=False)
    got = IF.fused_dot_product_attention(*T, dropout_p=0.5, is_causal=True,
                                         training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref._data),
                               rtol=F32_TOL, atol=F32_TOL)


# dropout's draws are torch's, so it is held to the reference by its rate
# and scale: the share of dropped probabilities within DROP_SIGMAS binomial
# standard deviations of p, and every kept one scaled by 1 / (1 - p); the
# mean output over DROP_DRAWS draws within DROP_SIGMAS standard errors
# (each element's own, over the draws) of the output without dropout
DROP_P, DROP_DRAWS, DROP_SIGMAS = 0.5, 256, 5.0


def test_fused_dot_product_attention_dropout_rate_and_scale():
    """With v the identity (sk = d = 16 keys), each output row is the
    row's probabilities, so the draws show the mask itself."""
    rs = np.random.RandomState(11)
    b, s, h = 2, 16, 2
    q, k = _rand(rs, b, s, h, s), _rand(rs, b, s, h, s)
    v = np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None],
                        (b, s, h, s)).copy()
    def ref(p):
        return np.asarray(jax.jit(lambda *a: JIF.fused_dot_product_attention(
            *(paddle.Tensor(x) for x in a), dropout_p=p)._data)(q, k, v))
    probs = ref(0.0)
    reps = lambda x: torch.as_tensor(x).repeat(DROP_DRAWS, 1, 1, 1)
    gen = torch.Generator().manual_seed(0)
    with pt_random.generator_scope(gen):
        got = IF.fused_dot_product_attention(reps(q), reps(k), reps(v),
                                             dropout_p=DROP_P)
    got = got.numpy().reshape(DROP_DRAWS, b, s, h, s)
    for out in (got, ref(DROP_P)[None]):
        dropped = out == 0
        n = dropped.size
        assert abs(dropped.mean() - DROP_P) <= DROP_SIGMAS * np.sqrt(
            DROP_P * (1 - DROP_P) / n)
        kept = np.broadcast_to(probs / (1 - DROP_P), out.shape)[~dropped]
        np.testing.assert_allclose(out[~dropped], kept, rtol=F32_TOL,
                                   atol=F32_TOL)
    sem = got.std(0) / np.sqrt(DROP_DRAWS)
    assert (np.abs(got.mean(0) - probs) <= DROP_SIGMAS * sem + 1e-6).all()
