"""The port's autograd (paddle_tpu_torch.autograd, the top-level grad and
grad-mode switches) against the JAX package's, on the cases of
tests/test_autograd.py.

Each parity case is written once against a package `K.P` and runs twice:
through the port in float32 on the CPU, and through the reference traced
under one jax.jit (its eager ops would compile one by one). Inputs are
numpy draws from a seed. The engine's own behaviours (errors, hooks on
saved tensors, the NaN/Inf checker) are checked on the port, with the
reference's own outcome beside them where one op shows it.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


class _Ref:
    P = paddle

    @staticmethod
    def leaf(a):
        return RefTensor(a, stop_gradient=False)

    @staticmethod
    def const(a):
        return RefTensor(a)


class _Port:
    P = pt

    @staticmethod
    def leaf(a):
        return a.clone().requires_grad_(True)

    @staticmethod
    def const(a):
        return a


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(case, arrays, eager=False):
    """(port outputs, reference outputs) as numpy arrays; the reference
    eagerly where it reads a shape as a value."""
    ref_fn = lambda *a: [o._data for o in _flat(case(_Ref, *a))]  # noqa: E731
    ref = (ref_fn if eager else jax.jit(ref_fn))(
        *(jax.numpy.asarray(a) for a in arrays))
    port = _flat(case(_Port, *(torch.as_tensor(a) for a in arrays)))
    return ([np.asarray(o.detach()) for o in port],
            [np.asarray(o) for o in ref])


# -- the cases: each f(K, *arrays) -> tensors ------------------------------

def c_chain(K, x):
    x = K.leaf(x)
    (x * x).sum().backward()
    return [x.grad]


def c_matmul(K, a, b):
    a, b = K.leaf(a), K.leaf(b)
    K.P.matmul(a, b).sum().backward()
    return [a.grad, b.grad]


def c_branching(K, x):
    x = K.leaf(x)
    ((x * 2) + (x * 3)).sum().backward()
    return [x.grad]


def c_accumulates(K, x):
    x = K.leaf(x)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    return [x.grad]


def c_stop_gradient(K, x, y):
    x = K.leaf(x)
    (x * K.const(y)).sum().backward()
    return [x.grad]


def c_detach(K, x):
    x = K.leaf(x)
    ((x * 2).detach() * x).sum().backward()
    return [x.grad]


def c_tanh_softmax(K, x, w):
    x = K.leaf(x)
    (K.P.nn.functional.softmax(K.P.tanh(x)) * K.const(w)).sum().backward()
    return [x.grad]


def c_retain_graph(K, x):
    x = K.leaf(x)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    return [x.grad]


def c_grad_api(K, x):
    x = K.leaf(x)
    return K.P.grad(x * x, x)


def c_grad_intermediate(K, x):
    x = K.leaf(x)
    y = x * 2
    return K.P.grad(y * y, y)


def _tanh_layer(K):
    class MyTanh(K.P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a):
            ctx.save_for_backward(a)
            return K.P.tanh(a)

        @staticmethod
        def backward(ctx, dy):
            (a,) = ctx.saved_tensor()
            t = K.P.tanh(a)
            return dy * (1.0 - t * t)
    return MyTanh


def c_pylayer(K, x):
    class Double(K.P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    x = K.leaf(x)
    Double.apply(x).sum().backward()
    return [x.grad]


def c_pylayer_multi_input(K, a, b):
    class Mul(K.P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, u, w):
            ctx.save_for_backward(u, w)
            return u * w

        @staticmethod
        def backward(ctx, g):
            u, w = ctx.saved_tensor()
            return g * w, g * u

    a, b = K.leaf(a), K.leaf(b)
    Mul.apply(a, b).sum().backward()
    return [a.grad, b.grad]


def c_pylayer_double_grad(K, x):
    x = K.leaf(x)
    (g,) = K.P.grad(_tanh_layer(K).apply(x).sum(), x, create_graph=True)
    (h,) = K.P.grad(g.sum(), x)
    return [g, h]


def c_cubic(K, x):
    x = K.leaf(x)
    (g,) = K.P.grad((x * x * x).sum(), x, create_graph=True)
    (h,) = K.P.grad(g.sum(), x)
    return [g, h]


def c_matmul_double(K, x, w):
    x, w = K.leaf(x), K.leaf(w)
    (gx,) = K.P.grad(((x @ w) * (x @ w)).sum(), x, create_graph=True)
    return K.P.grad((gx * gx).sum(), x)


def c_tanh_mlp(K, x, w1, w2):
    x, w1, w2 = K.leaf(x), K.leaf(w1), K.leaf(w2)
    (gx,) = K.P.grad((K.P.tanh(x @ w1) @ w2).sum(), x, create_graph=True)
    return K.P.grad(gx.sum(), [x, w1, w2])


def c_other_leaf(K, x, w):
    x, w = K.leaf(x), K.leaf(w)
    (gx,) = K.P.grad(((x @ w) ** 2).sum(), x, create_graph=True)
    return K.P.grad(gx.sum(), w)


def c_hessian_rows(K, x):
    x = K.leaf(x)
    (g,) = K.P.grad((x * x * x).sum(), x, create_graph=True)
    return [K.P.grad(g[i], x, retain_graph=True)[0] for i in range(3)]


def c_grad_outputs(K, x, v):
    x = K.leaf(x)
    (g,) = K.P.grad(x * x, x, grad_outputs=K.const(v), create_graph=True)
    return [g] + K.P.grad(g.sum(), x)


def c_hook(K, x):
    x = K.leaf(x)
    seen = []
    x.register_hook(lambda g: (seen.append(g), g * 2.0)[1])
    (x * x).sum().backward()
    return [x.grad, seen[0]]


def c_hook_once(K, x):
    x = K.leaf(x)
    calls = []
    x.register_hook(lambda g: calls.append(g))
    ((x * 3.0).sum() + (x * x).sum()).backward()
    assert len(calls) == 1
    return [x.grad, calls[0]]


def c_hook_intermediate(K, x):
    x = K.leaf(x)
    mid = x * 3.0
    mid.register_hook(lambda g: g * 10.0)
    (mid * 2.0).sum().backward()
    return [x.grad]


def c_hook_removed(K, x):
    x = K.leaf(x)
    x.register_hook(lambda g: g * 100.0).remove()
    (x * x).sum().backward()
    return [x.grad]


def c_vjp_jvp(K, x, v):
    f = lambda t: K.P.tanh(t) * t   # noqa: E731
    out, g = K.P.autograd.vjp(f, K.const(x))
    _, gv = K.P.autograd.vjp(f, K.const(x), K.const(v))
    out2, t = K.P.autograd.jvp(f, K.const(x))
    _, tv = K.P.autograd.jvp(f, K.const(x), K.const(v))
    return [out, g, gv, out2, t, tv]


def c_vjp_two_inputs(K, x, y):
    _, gs = K.P.autograd.vjp(lambda a, b: (a * b * b).sum(),
                             [K.const(x), K.const(y)])
    return gs


def c_jacobian(K, x):
    return K.P.autograd.jacobian(lambda t: K.P.tanh(t) * t, K.const(x))


def c_jacobian_two_inputs(K, x, y):
    return K.P.autograd.jacobian(lambda a, b: a * b + a,
                                 [K.const(x), K.const(y)])


def c_jacobian_of_tensor(K, x):
    x = K.leaf(x)
    return K.P.autograd.jacobian(K.P.tanh(x) * x, x)


def c_hessian(K, x):
    return K.P.autograd.hessian(lambda t: (t * t * t).sum(), K.const(x))


def c_hessian_two_inputs(K, x, y):
    return K.P.autograd.hessian(lambda a, b: (a * a * b).sum(),
                                [K.const(x), K.const(y)])


def _arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = {
    "chain": (c_chain, [np.array([2.0, 3.0], np.float32)]),
    "matmul": (c_matmul, [np.random.RandomState(0).rand(3, 4).astype(
        np.float32), np.random.RandomState(1).rand(4, 2).astype(np.float32)]),
    "branching": (c_branching, [np.array([1.0, 2.0], np.float32)]),
    "accumulates": (c_accumulates, [np.array([1.0], np.float32)]),
    "stop_gradient": (c_stop_gradient, [np.array([1.0], np.float32),
                                        np.array([2.0], np.float32)]),
    "detach": (c_detach, [np.array([3.0], np.float32)]),
    "tanh_softmax": (c_tanh_softmax, [np.random.RandomState(0).rand(5)
                                      .astype(np.float32),
                                      np.arange(1.0, 6.0, dtype=np.float32)]),
    "retain_graph": (c_retain_graph, [np.array([2.0], np.float32)]),
    "grad_api": (c_grad_api, [np.array([2.0], np.float32)]),
    "grad_intermediate": (c_grad_intermediate, [np.array([3.0], np.float32)]),
    "pylayer": (c_pylayer, [np.array([1.0, 2.0], np.float32)]),
    "pylayer_multi_input": (c_pylayer_multi_input,
                            [np.array([2.0], np.float32),
                             np.array([3.0], np.float32)]),
    "pylayer_double_grad": (c_pylayer_double_grad, [_arr(6, 5)]),
    "cubic": (c_cubic, [np.array([2.0], np.float32)]),
    "matmul_double": (c_matmul_double, [_arr(0, 3, 4), _arr(1, 4, 2)]),
    "tanh_mlp": (c_tanh_mlp, [_arr(0, 3, 4), _arr(2, 4, 8), _arr(3, 8, 1)]),
    "other_leaf": (c_other_leaf, [_arr(4, 2, 3), _arr(5, 3, 2)]),
    "hessian_rows": (c_hessian_rows, [_arr(7, 3)]),
    "grad_outputs": (c_grad_outputs, [_arr(8, 4), _arr(9, 4)]),
    "hook": (c_hook, [np.array([1.0, 2.0, 3.0], np.float32)]),
    "hook_once": (c_hook_once, [np.array([1.0, 2.0], np.float32)]),
    "hook_intermediate": (c_hook_intermediate, [np.array([2.0], np.float32)]),
    "hook_removed": (c_hook_removed, [np.array([1.0], np.float32)]),
    "vjp_jvp": (c_vjp_jvp, [_arr(10, 4), _arr(11, 4)]),
    "vjp_two_inputs": (c_vjp_two_inputs, [_arr(12, 3), _arr(13, 3)]),
    "jacobian": (c_jacobian, [_arr(14, 3)]),
    "jacobian_two_inputs": (c_jacobian_two_inputs, [_arr(15, 3),
                                                    _arr(16, 3)]),
    "jacobian_of_tensor": (c_jacobian_of_tensor, [_arr(17, 3)]),
    "hessian": (c_hessian, [_arr(18, 3)]),
    "hessian_two_inputs": (c_hessian_two_inputs, [_arr(19, 2),
                                                  _arr(20, 2)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    case, arrays = CASES[name]
    port, ref = _run(case, arrays, eager=name == "jacobian_of_tensor")
    assert len(port) == len(ref) > 0
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p.shape == r.shape, (name, i, p.shape, r.shape)
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}[{i}]")


# -- the engine's behaviours on the port -----------------------------------

def test_grad_leaves_dot_grad_and_refuses_unused():
    x = torch.tensor([1.0], requires_grad=True)
    u = torch.tensor([1.0], requires_grad=True)
    const = torch.tensor([1.0])
    y = x * 2
    (gx,) = pt.grad(y, x, retain_graph=True)
    assert x.grad is None and float(gx) == 2.0
    assert pt.grad(y, [x, u, const], retain_graph=True,
                   allow_unused=True)[1:] == [None, None]
    with pytest.raises(RuntimeError, match="unused"):
        pt.grad(y, [x, u])


def test_grad_modes():
    x = torch.tensor([1.0], requires_grad=True)
    with pt.no_grad():
        assert not (x * 2).requires_grad and not pt.is_grad_enabled()
        with pt.enable_grad():
            assert (x * 2).requires_grad
    f = pt.no_grad(lambda t: t * 2)
    assert not f(x).requires_grad and pt.is_grad_enabled()
    with pt.set_grad_enabled(False):
        assert not pt.autograd.is_grad_enabled()
    assert pt.is_grad_enabled_()


def test_freed_graph_and_inplace_mutation_raise():
    x = torch.tensor([1.5], requires_grad=True)
    y = (x * x).sum()
    pt.grad(y, x)
    with pytest.raises(RuntimeError):
        pt.grad(y, x, create_graph=True)
    y = (x * x).sum()
    with torch.no_grad():
        x.copy_(torch.tensor([3.0]))
    with pytest.raises(RuntimeError, match="inplace"):
        pt.grad(y, x, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.ones(1).register_hook(lambda g: g)


def test_saved_tensors_hooks_fire():
    packed, unpacked = [], []

    class Sq(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 2 * x

    x = torch.tensor([3.0], requires_grad=True)
    with pt.autograd.saved_tensors_hooks(
            lambda t: (packed.append(t), t)[1],
            lambda t: (unpacked.append(t), t)[1]):
        y = Sq.apply(x)
    y.backward()
    assert packed and unpacked and float(x.grad) == 6.0


def test_pylayer_keyword_and_non_tensor_arguments():
    class Scale(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k, bias=None):
            assert isinstance(ctx, pt.autograd.PyLayerContext)
            ctx.k = k
            return x * k + bias

        @staticmethod
        def backward(ctx, g):
            return g * ctx.k

    x = torch.tensor([1.0, 2.0], requires_grad=True)
    Scale.apply(x, 3.0, bias=torch.ones(2)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [3.0, 3.0])


def test_incubate_autograd():
    ia = pt.incubate.autograd
    assert ia.Jacobian is pt.autograd.jacobian
    assert ia.Hessian is pt.autograd.hessian
    assert ia.prim_enabled()
    ia.disable_prim()
    assert not ia.prim_enabled()
    ia.enable_prim()
    assert ia.prim2orig("block") == "block"


class TestNanInfChecker:
    """FLAGS_check_nan_inf on the port (a dispatch mode over aten ops) and
    the reference (its dispatcher) on the same one-op inputs."""

    @pytest.fixture(params=["port", "reference"])
    def side(self, request):
        P = pt if request.param == "port" else paddle
        T = (torch.tensor if request.param == "port" else
             (lambda a, **kw: paddle.to_tensor(
                 np.asarray(a, np.float32),
                 stop_gradient=not kw.get("requires_grad", False))))
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            yield P, T
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False,
                         "FLAGS_check_nan_inf_level": 0})

    def test_forward_nan_raises(self, side):
        P, T = side
        with pytest.raises(RuntimeError, match="NaN or Inf"):
            P.sqrt(T([-1.0]))

    def test_backward_inf_raises(self, side):
        P, T = side
        x = T([0.0], requires_grad=True)
        y = P.sqrt(x).sum()
        with pytest.raises(RuntimeError, match="NaN or Inf"):
            y.backward()

    def test_level_warns_instead(self, side):
        P, T = side
        P.set_flags({"FLAGS_check_nan_inf_level": 1})
        with pytest.warns(RuntimeWarning, match="NaN or Inf"):
            P.sqrt(T([-1.0]))

    def test_disabled_by_default(self):
        from torch.utils._python_dispatch import _get_current_dispatch_mode
        assert _get_current_dispatch_mode() is None
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert torch.isnan(pt.sqrt(torch.tensor([-1.0]))).all()
