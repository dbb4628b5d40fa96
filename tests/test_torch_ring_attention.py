"""The port's ring attention (paddle_tpu_torch/ops/ring_attention.py)
against the reference's under shard_map on its virtual CPU devices, as
tests/test_models.py's TestRingAttention and TestRingFlashAttention run
it: rings of 2 and 4 shards, causal and not, the dense and the flash
ring, outputs and gradients, the same numpy-seeded float32 inputs.
Tolerance: 1e-5 absolute and relative (float32 math on both sides; the
reference's own tests hold the two rings to 2e-3)."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu_torch.distributed as dist
from paddle_tpu.ops.ring_attention import ring_attention as ref_ring
from paddle_tpu_torch.ops.ring_attention import ring_attention
from torch_one_thread import one_torch_thread  # noqa: F401

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

# the module (paddle_tpu_torch.ops.ring_attention is also the function's
# name in the ops package)
ring_mod = importlib.import_module("paddle_tpu_torch.ops.ring_attention")
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, D = 1, 32, 2, 8
CASES = [(n, causal, flash) for n in (2, 4) for causal in (False, True)
         for flash in (False, True)]


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.rand(B, S, H, D).astype(np.float32) for _ in range(3)]


def _reference(n, causal, flash, qkv, grads):
    """The reference's output and, with `grads`, the gradients of
    sum(out ** 2): one jitted program a case."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sep",))
    fn = shard_map(
        lambda q, k, v: ref_ring(q, k, v, "sep", causal=causal,
                                 use_flash=flash),
        mesh=mesh, in_specs=(JP(None, "sep"),) * 3,
        out_specs=JP(None, "sep"))
    args = [jnp.asarray(a) for a in qkv]
    if not grads:
        return np.asarray(jax.jit(fn)(*args)), None

    def loss(*a):
        out = fn(*a)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True))(*args)
    return np.asarray(out), [np.asarray(x) for x in g]


@pytest.fixture(scope="module")
def reference():
    """{(n, causal, flash): (out, grads or None)}, each computed once."""
    qkv = _inputs()
    return qkv, {c: _reference(*c, qkv, grads=c[1]) for c in CASES}


def _port(n, qkv, requires_grad=False):
    mesh = dist.ProcessMesh(shape=[n], dim_names=["sep"], device="cpu")
    return [dist.shard_tensor(torch.from_numpy(a), mesh, [dist.Shard(1)],
                              stop_gradient=not requires_grad) for a in qkv]


@pytest.mark.parametrize("n,causal,flash", CASES)
def test_outputs_match_reference(reference, n, causal, flash):
    qkv, ref = reference
    out = ring_attention(*_port(n, qkv), "sep", causal=causal,
                         use_flash=flash)
    np.testing.assert_allclose(out.numpy(), ref[(n, causal, flash)][0],
                               **TOL)
    assert out.placements == [dist.Shard(1)]


@pytest.mark.parametrize("n,flash", [(2, False), (2, True), (4, False),
                                     (4, True)])
def test_causal_grads_match_reference(reference, n, flash):
    qkv, ref = reference
    q, k, v = _port(n, qkv, requires_grad=True)
    out = ring_attention(q, k, v, "sep", causal=True, use_flash=flash)
    (out ** 2).sum().backward()
    for got, want in zip((q.grad, k.grad, v.grad), ref[(n, True, flash)][1]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_ring_calls_k1_once_a_step(monkeypatch):
    """The n shards are stacked into K1's batch: n calls a ring of n, the
    head dim padded to the kernel's (64 for d8)."""
    calls = []
    real = ring_mod._flash_fwd_bhsd

    def counting(q, k, v, causal, scale):
        calls.append((tuple(q.shape), causal))
        return real(q, k, v, causal, scale)

    monkeypatch.setattr(ring_mod, "_flash_fwd_bhsd", counting)
    ring_attention(*_port(4, _inputs(1)), "sep", causal=True, use_flash=True)
    shape = (4 * B * H, S // 4, ring_mod._padded_dim(D))
    assert calls == [(shape, True)] + [(shape, False)] * 3


def test_needs_a_sequence_sharded_mesh():
    q = torch.zeros(B, S, H, D)
    with pytest.raises(ValueError, match="process_mesh"):
        ring_attention(q, q, q, "sep")
    mesh = dist.ProcessMesh(shape=[4], dim_names=["sep"], device="cpu")
    q = dist.shard_tensor(q, mesh, [dist.Replicate()])
    with pytest.raises(ValueError, match="Shard"):
        ring_attention(q, q, q, "sep")
    # on the CPU use_flash=None takes the dense ring
    q = dist.shard_tensor(torch.from_numpy(_inputs(2)[0]), mesh,
                          [dist.Shard(1)])
    torch.testing.assert_close(ring_attention(q, q, q, "sep"),
                               ring_attention(q, q, q, "sep",
                                              use_flash=False),
                               rtol=0, atol=0)
