"""Helpers shared by the op-by-op parity tests (test_torch_tensor_math,
test_torch_tensor_stat_random, test_torch_linalg, test_torch_tensor_extras,
test_torch_nn_more): arguments that go in as each package's tensor, the
outputs as numpy arrays, and their comparison.

The reference runs one JAX op at a time, and each op compiles at its
first call with a shape: a function of fifty primitives compiles fifty
times, and its eager backward as many more. So `ref_call` runs it under
one jax.jit (jax.value_and_grad for gradients), as the reference's own
jit.to_static does, and falls back to the eager call for functions that
read their data on the host (histograms, bincount, ...).

Floats are compared at the tolerance a test states; integers and bools
exactly. Integer dtypes are compared by kind: the reference's are int32
where JAX runs without 64-bit types, the port's int64 as Paddle's. bf16
outputs must be bf16 on both sides and are compared as float32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor


class Arr:
    """An argument that goes in as each package's tensor."""

    def __init__(self, a, dtype=None):
        self.a, self.dtype = a, dtype


def A(a, dtype=None):
    return Arr(a, dtype)


def conv(v, port):
    if isinstance(v, Arr):
        if port:
            t = torch.tensor(v.a)
            return t if v.dtype is None else t.to(getattr(torch, v.dtype))
        return paddle.to_tensor(v.a, dtype=v.dtype)
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], Arr):
        return type(v)(conv(e, port) for e in v)
    return v


def to_np(out):
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            return out.float().numpy(), "bfloat16"
        return out.numpy(), None
    if hasattr(out, "_data"):
        a = np.asarray(out._data)
        if str(a.dtype) == "bfloat16":
            return a.astype(np.float32), "bfloat16"
        return a, None
    if isinstance(out, (tuple, list)):
        return [to_np(o) for o in out], None
    if hasattr(out, "dtype") and hasattr(out, "shape"):   # a jax array
        return to_np(paddle.to_tensor(np.asarray(out)))
    return out, None


def same(p, r, tol, where="out"):
    """Port output p against reference output r (both from to_np)."""
    (pv, ptag), (rv, rtag) = p, r
    assert ptag == rtag, (where, ptag, rtag)
    if isinstance(rv, list):
        assert isinstance(pv, list) and len(pv) == len(rv), where
        for i, (a, b) in enumerate(zip(pv, rv)):
            same(a, b, tol, f"{where}[{i}]")
        return
    if not isinstance(rv, np.ndarray):
        if isinstance(pv, np.ndarray):
            pv = pv.item()
        assert pv == rv or np.isclose(pv, rv, **tol), (where, pv, rv)
        return
    assert isinstance(pv, np.ndarray), (where, type(pv))
    assert pv.shape == rv.shape, (where, pv.shape, rv.shape)
    assert pv.dtype.kind == rv.dtype.kind, (where, pv.dtype, rv.dtype)
    if rv.dtype.kind in "fc":
        np.testing.assert_allclose(pv, rv, err_msg=where, **tol)
    else:
        np.testing.assert_array_equal(pv, rv, err_msg=where)


def _leaves(v, out):
    """v with each Arr (in lists, tuples and dicts too) replaced by its
    index in `out`, where its reference array is appended."""
    if isinstance(v, Arr):
        out.append(np.asarray(conv(v, False)._data))
        return ("__leaf__", len(out) - 1)
    if isinstance(v, (list, tuple)):
        return type(v)(_leaves(e, out) for e in v)
    if isinstance(v, dict):
        return {k: _leaves(e, out) for k, e in v.items()}
    return v


def _fill(v, arrs):
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "__leaf__":
        return RefTensor(arrs[v[1]])
    if isinstance(v, (list, tuple)):
        return type(v)(_fill(e, arrs) for e in v)
    if isinstance(v, dict):
        return {k: _fill(e, arrs) for k, e in v.items()}
    return v


def _data(out):
    return jax.tree_util.tree_map(
        lambda t: t._data if isinstance(t, RefTensor) else t, out,
        is_leaf=lambda t: isinstance(t, RefTensor))


def ref_call(fn, args, kwargs, w=None):
    """fn(*args, **kwargs) of the reference, under one jax.jit; with `w`,
    also the gradient of sum(out * w) (out the first output) in each float
    argument (None for the rest). Returns (outputs, grads) as reference
    Tensors; grads is None without `w`. Eager where tracing fails."""
    arrs = []
    a_t, k_t = _leaves(list(args), arrs), _leaves(dict(kwargs), arrs)

    def f(*xs):
        return _data(fn(*_fill(a_t, xs), **_fill(k_t, xs)))

    floats = [i for i, a in enumerate(arrs) if a.dtype.kind == "f"
              or str(a.dtype) == "bfloat16"]
    wrap = lambda o: jax.tree_util.tree_map(RefTensor, o)
    try:
        if not arrs:
            raise TypeError("no tensor arguments")
        if w is None:
            return wrap(jax.jit(f)(*arrs)), None

        def loss(*xs):
            out = f(*xs)
            first = out[0] if isinstance(out, (tuple, list)) else out
            return jnp.sum(first * w), out

        (_, out), g = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(floats), has_aux=True))(*arrs)
        grads = [None] * len(arrs)
        for i, gi in zip(floats, g):
            grads[i] = RefTensor(gi)
        return wrap(out), grads
    except (TypeError, jax.errors.ConcretizationTypeError,
            jax.errors.TracerArrayConversionError,
            jax.errors.TracerIntegerConversionError,
            jax.errors.TracerBoolConversionError):
        if w is not None:
            raise
        return fn(*[conv(a, False) for a in args],
                  **{k: conv(v, False) for k, v in kwargs.items()}), None


def port_call(fn, args, kwargs, requires_grad=False):
    """fn(*args, **kwargs) of the port; returns (outputs, its tensor
    arguments in ref_call's order). With `requires_grad`, the float ones
    require grad."""
    leaves = []

    def build(v):
        if isinstance(v, Arr):
            t = conv(v, True)
            if requires_grad and t.is_floating_point():
                t.requires_grad_(True)
            leaves.append(t)
            return t
        if isinstance(v, (list, tuple)):
            return type(v)(build(e) for e in v)
        if isinstance(v, dict):
            return {k: build(e) for k, e in v.items()}
        return v

    a, k = build(list(args)), build(dict(kwargs))
    return fn(*a, **k), leaves


def run(path, args, kwargs, tol):
    """Call `path` (dotted, from each package's root) on both packages with
    the same arguments and compare the outputs."""
    def resolve(root):
        obj = root
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    r, _ = ref_call(resolve(paddle), args, kwargs)
    p = resolve(pt)(*[conv(a, True) for a in args],
                    **{k: conv(v, True) for k, v in kwargs.items()})
    same(to_np(p), to_np(r), tol)
    return p, r
