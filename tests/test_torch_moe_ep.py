"""The port's expert parallelism (parallel/moe.py) against the JAX
package's, the reference on its virtual CPU devices: gshard_dispatch's
buffers, combine weights and drops, ExpertParallelMoE's output and
load-balancing loss at ep 1, 2 and 4 with the default capacity factor
(tokens dropped), ep against local where no token drops, and the
converter of the reference's init dict. Float32; tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.parallel import moe as rmoe
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import moe_params_from_reference
from paddle_tpu_torch.parallel import moe
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
T, D, H, E = 32, 8, 16, 4


def _x_logits(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(T, D).astype(np.float32),
            rs.randn(T, E).astype(np.float32))


@pytest.mark.parametrize("capacity", [32, 5])
def test_gshard_dispatch_matches_reference(capacity):
    x, logits = _x_logits()
    want = jax.jit(rmoe.gshard_dispatch, static_argnums=(2, 3, 4))(
        jnp.asarray(x), jnp.asarray(logits), E, capacity, 2)
    got = moe.gshard_dispatch(torch.from_numpy(x), torch.from_numpy(logits),
                              E, capacity, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # a dropped (token, choice) has no combine weight: capacity 5 drops
    dropped = moe.dropped_choices(torch.from_numpy(logits), E, capacity)
    kept = int((got[1] > 0).sum())
    assert kept + dropped == 2 * T and (dropped > 0) == (capacity == 5)


def _params():
    rs = np.random.RandomState(1)
    return {"gate": (rs.randn(D, E) / np.sqrt(D)).astype(np.float32),
            "w1": (rs.randn(E, D, H) / np.sqrt(D)).astype(np.float32),
            "w2": (rs.randn(E, H, D) / np.sqrt(H)).astype(np.float32)}


@pytest.mark.parametrize("ep", [1, 2, 4])
def test_expert_parallel_moe_matches_reference(ep):
    x, _ = _x_logits()
    np_params = _params()
    rmesh = Mesh(np.asarray(jax.devices()[:ep]), ("ep",)) if ep > 1 else None
    ref = rmoe.ExpertParallelMoE(D, H, E, mesh=rmesh)
    want, want_aux = jax.jit(ref.apply)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    mesh = dist.ProcessMesh(shape=[ep], dim_names=["ep"], device="cpu") \
        if ep > 1 else None
    port = moe.ExpertParallelMoE(D, H, E, mesh=mesh)
    params = moe_params_from_reference(np_params, "cpu", mesh=mesh)
    got, aux = port.apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
    if mesh is not None:
        assert params["w1"].placements == [dist.Shard(0)]


def test_ep_equals_local_where_nothing_drops():
    """At a capacity factor of E / top_k every token keeps both choices on
    every shard: ep 4 is the local layer; gradients flow to every weight."""
    x, _ = _x_logits(2)
    mesh = dist.ProcessMesh(shape=[4], dim_names=["ep"], device="cpu")
    local = moe.ExpertParallelMoE(D, H, E, capacity_factor=E / 2)
    par = moe.ExpertParallelMoE(D, H, E, mesh=mesh, capacity_factor=E / 2)
    params = local.init(0, device="cpu")
    for p in params.values():
        p.requires_grad_()
    a, _ = local.apply(params, torch.from_numpy(x))
    ga = torch.autograd.grad(a.square().sum(), list(params.values()))
    b, _ = par.apply(params, torch.from_numpy(x))
    gb = torch.autograd.grad(b.square().sum(), list(params.values()))
    torch.testing.assert_close(b, a, **TOL)
    for u, w in zip(gb, ga):
        torch.testing.assert_close(u, w, **TOL)
        assert u.abs().sum() > 0
    with pytest.raises(KeyError):
        moe_params_from_reference({"gate": np.zeros((D, E))}, "cpu")
    with pytest.raises(ValueError, match="w2"):
        moe_params_from_reference(dict(_params(), w2=np.zeros((E, H, H))),
                                  "cpu")
