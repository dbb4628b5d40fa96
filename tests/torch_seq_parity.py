"""Helpers shared by the sequence-model parity tests (test_torch_rnn,
test_torch_transformer, test_torch_decode, test_torch_seq_slice): numpy
views of the reference's tensors, reference layers with weights drawn
from numpy, the reference's weights copied into a port model key for key,
and the reference's outputs and gradients through its jitted
functional_call.

The reference runs eagerly one JAX op at a time, and each op compiles on
its first call at a shape: a small model's forward and backward take
hundreds of compiles, several seconds on the CPU. Its functional_call
under jax.jit (the path its jit.to_static and trainers take, and
jax.value_and_grad for the gradients) compiles each case once."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.framework.core import Tensor as RefTensor
from paddle_tpu.parallel.functional import functional_call as ref_call
from paddle_tpu_torch.convert import load_reference_state
from torch_zoo_parity import zero_reference_init


def ref_np(t):
    """A numpy copy of a reference Tensor (or a jax array)."""
    return np.asarray(getattr(t, "_data", t))


def reference(build, seed=0):
    """The reference layer `build()` makes, its parameters drawn from
    numpy's default_rng(seed): each of the reference's own initializer
    draws compiles a JAX op of its own, so it is built with them giving
    zeros. Matrices are Uniform(+-1/sqrt(first dim)), vectors named
    `weight` (norm scales) 1 + Uniform(+-0.1), other vectors (biases)
    Uniform(+-0.5)."""
    with zero_reference_init():
        ref = build()
    rng = np.random.default_rng(seed)
    for name, p in ref.named_parameters():
        shape = tuple(p.shape)
        if len(shape) > 1:
            v = rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        elif name.rsplit(".", 1)[-1] == "weight":
            v = 1.0 + rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.uniform(-0.5, 0.5, shape)
        p.set_value(v.astype(ref_np(p).dtype))
    return ref


def ref_state(layer):
    """The reference layer's state_dict as numpy arrays."""
    return {k: ref_np(v) for k, v in layer.state_dict().items()}


def copy_weights(port, ref):
    """The reference layer's weights into the port layer, key for key."""
    load_reference_state(port, ref_state(ref))
    return port


def nest_map(f, tree):
    """f over every leaf of a nest of tuples (named ones too), lists and
    dicts."""
    if isinstance(tree, (tuple, list)):
        items = [nest_map(f, t) for t in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    if isinstance(tree, dict):
        return {k: nest_map(f, v) for k, v in tree.items()}
    return f(tree)


def ref_run(ref, calls, loss=None, training=True):
    """`calls(forward)` under one jax.jit, where forward(*args, **kw) is
    the reference layer's functional_call on its parameters and on args
    given as numpy arrays (nests of them, or None). Returns its outputs as
    numpy arrays and, with `loss` (outputs -> a jnp scalar), the gradient
    of the loss for every parameter by name (else None)."""
    params = {n: p._data for n, p in ref.named_parameters()}

    def to_ref(a):
        if a is None or isinstance(a, RefTensor):
            return a
        return RefTensor(jnp.asarray(a))

    def f(p):
        def forward(*args, **kw):
            return ref_call(ref, p, *nest_map(to_ref, args),
                            training=training, **nest_map(to_ref, kw))
        out = calls(forward)
        return (loss(out) if loss else jnp.zeros(())), out

    if loss is None:
        out, grads = jax.jit(lambda p: f(p)[1])(params), None
    else:
        (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params)
        grads = {k: np.asarray(v) for k, v in grads.items()}
    return nest_map(np.asarray, out), grads


def port_grads(port):
    """{name: numpy grad} of the port layer's parameters, zeros where a
    parameter got none (jax.grad gives zeros there)."""
    return {n: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.detach().float().numpy())
            for n, p in port.named_parameters()}


def assert_grads_close(port, want, rtol, atol):
    """The port's gradients against ref_run's, name for name."""
    got = port_grads(port)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
