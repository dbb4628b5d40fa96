"""The port's flash-attention backward (K3/K4) against the JAX package's
at the reference kernel's own cases and the CUDA kernels' tile edges; GQA,
bf16, the autograd Function, head dims above 128 and the wrapper's checks
are tests/test_torch_flash_attention_bwd_autograd.py's.

paddle_tpu_torch.ops.flash_attention runs its plain torch versions for CPU
tensors; the reference's Pallas backward runs in interpret mode, as its own
tests run it (tests/test_flash_attention.py). Inputs are made with numpy
from a seed and handed to both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from torch_one_thread import one_torch_thread  # noqa: F401

# the reference kernel's own cases (tests/test_flash_attention.py:41)
CASES = [
    (256, 256, False),
    (256, 256, True),
    (200, 200, True),
    (384, 384, True),
    (520, 520, True),
    (128, 320, True),
    (100, 260, False),
    # the edges of the CUDA kernels' tiles (K3: 128 query rows over
    # 128-key tiles; K4: 128 keys over 64-row query tiles)
    (127, 127, True),
    (129, 129, True),
    (1, 300, False),
    (130, 1000, True),
    # causal sq > sk: the first 200 rows admit no key; dO is zero there
    (300, 100, True),
]
# f32 on both sides; dq, dk and dv sum up to a few hundred products of
# O(1) terms in another order (the Pallas kernel by 128-key blocks)
F32_TOL = 1e-4
# bf16: P and dS are rounded to bf16 at the same points on both sides but
# from f32 sums taken in another order, and the results are rounded to bf16
# (a relative step of 2^-8); held relative to the largest gradient
BF16_RTOL = 2e-2


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _port_bwd(q, k, v, g, causal, scale, rep=1):
    q, k, v, g = (torch.as_tensor(x) for x in (q, k, v, g))
    out, lse = fa._flash_fwd_bhsd(q, k, v, causal, scale, rep)
    return fa._flash_bwd_bhsd(q, k, v, out, lse, g, causal, scale, rep)


def _ref_bwd(q, k, v, g, causal, scale, rep=1, **blocks):
    q, k, v, g = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jfa._flash_fwd_bhsd(q, k, v, causal, scale, interpret=True,
                                   q_per_kv=rep, **blocks)
    return jfa._flash_bwd_bhsd(q, k, v, out, lse, g, causal, scale,
                               interpret=True, q_per_kv=rep, **blocks)


@pytest.mark.parametrize("sq,sk,causal", CASES)
def test_plain_backward_matches_pallas(sq, sk, causal):
    rs = np.random.RandomState(0)
    q, k, v = _rand(rs, 2, sq, 64), _rand(rs, 2, sk, 64), _rand(rs, 2, sk, 64)
    g = _rand(rs, 2, sq, 64)
    # rows that admit no key (causal sq > sk) are undefined in the forward:
    # with dO zero there they add nothing to any gradient
    if causal:
        g[:, :max(0, sq - sk)] = 0
    got = _port_bwd(q, k, v, g, causal, 0.125)
    want = _ref_bwd(q, k, v, g, causal, 0.125)
    for x, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)
