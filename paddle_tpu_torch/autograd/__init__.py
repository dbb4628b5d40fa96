"""paddle.autograd over torch.autograd. reference:
paddle_tpu/autograd/__init__.py (`backward`, `grad`, `PyLayer`,
`PyLayerContext`, the grad-mode switches, `saved_tensors_hooks`, `vjp`,
`jvp`, `jacobian`, `hessian`).

The reference records its own tape and differentiates a node's recorded
forward again for `create_graph=True`; here torch's tape does both, and a
PyLayer is a `torch.autograd.Function` whose backward is recorded like any
other op under `create_graph=True`, so it can be differentiated again.
The functional transforms run on the tape too (`torch.autograd.grad` and
`torch.autograd.functional`), not `torch.func`: the flash-attention
Functions (ops/flash_attention.py) have no `setup_context` and torch.func
refuses them, while the tape takes them, second order included through
scaled_dot_product_attention's kernel branch.
"""

from __future__ import annotations

import torch

__all__ = ["backward", "grad", "PyLayer", "PyLayerContext", "no_grad",
           "saved_tensors_hooks", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "jvp", "vjp", "hessian", "jacobian"]

enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def no_grad(func=None):
    """A context in which no graph is recorded; with a function, that
    function run so."""
    return torch.no_grad() if func is None else torch.no_grad()(func)


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _cotangents(outs, given):
    """Each output's cotangent: the one given, else ones (Paddle's
    default, for outputs of any shape)."""
    given = [None] * len(outs) if given is None else _as_list(given)
    return [torch.ones_like(o) if g is None else g
            for o, g in zip(outs, given)]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `tensors` into the leaves' `.grad`; a
    missing grad_tensors entry is ones."""
    tensors = _as_list(tensors)
    torch.autograd.backward(tensors, _cotangents(tensors, grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, name=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`, as
    a list, without touching `.grad`; a missing grad_outputs entry is
    ones. With create_graph=True they are
    recorded, so they can be differentiated again; retain_graph defaults
    to create_graph. An input the outputs do not reach (or one that does
    not require grad) is None with allow_unused=True and raises
    RuntimeError otherwise. `only_inputs` and `no_grad_vars` are accepted
    and not read, as in the reference."""
    outs = _as_list(outputs)
    ins = _as_list(inputs)
    gouts = _cotangents(outs, grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    live = [i for i, t in enumerate(ins) if t.requires_grad]
    pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
    found = [None] * len(ins)
    if live and pairs:
        got = torch.autograd.grad(
            [o for o, _ in pairs], [ins[i] for i in live],
            [g for _, g in pairs], retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, got):
            found[i] = g
    if not allow_unused and any(g is None for g in found):
        raise RuntimeError(
            "One of the differentiated tensors appears unused; pass "
            "allow_unused=True to return None for it")
    return found


# ---------------------------------------------------------------------------
# PyLayer: custom forward and backward
# ---------------------------------------------------------------------------


class PyLayerContext:
    """What a PyLayer's forward leaves for its backward: the tensors of
    `save_for_backward` (read back by `saved_tensor()`, through torch's
    saved-tensor hooks) and any attribute set on it."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved = ()
        self.materialize_grads = True
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        if self._ctx is None:
            self._saved = tensors
        else:
            self._ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        """The tensors given to save_for_backward, as a tuple."""
        return self._saved if self._ctx is None else self._ctx.saved_tensors

    def saved_tensors(self):
        return self.saved_tensor()

    def mark_not_inplace(self, *args):
        self.not_inplace_tensors = args

    def mark_non_differentiable(self, *tensors):
        self._ctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, value):
        self.materialize_grads = bool(value)
        if self._ctx is not None:
            self._ctx.set_materialize_grads(bool(value))


class _PyLayerFunction(torch.autograd.Function):
    """The torch Function under every PyLayer: forward(ctx, layer, kwargs,
    *args) runs the layer's forward; backward hands its gradients back
    one per argument, None for those that are no tensor."""

    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        ctx.layer = layer
        ctx.pctx = PyLayerContext(ctx)
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        return layer.forward(ctx.pctx, *args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        res = ctx.layer.backward(ctx.pctx, *grads)
        res = iter(res if isinstance(res, (list, tuple)) else (res,))
        return (None, None) + tuple(next(res, None) if t else None
                                    for t in ctx.is_tensor)


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    """Custom autograd: subclass with static `forward(ctx, *args,
    **kwargs)` and `backward(ctx, *grads)` (one gradient per tensor
    argument of forward, in order), call `apply`. The backward's own ops
    are recorded under create_graph=True, so its gradients can be taken
    again."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _PyLayerFunction.apply(cls, kwargs, *args)


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):
    """pack_hook(tensor) runs as a tensor is saved for the backward,
    unpack_hook(packed) as the backward reads it (host offload, say). The
    reference applies them to a PyLayer's `save_for_backward` alone; torch
    applies them to every op's saved tensors, as Paddle's own do."""

    def __init__(self, pack_hook, unpack_hook):
        super().__init__(pack_hook, unpack_hook)


# ---------------------------------------------------------------------------
# functional transforms, on the tape
# ---------------------------------------------------------------------------


def _single(seq, xs):
    return seq[0] if not isinstance(xs, (list, tuple)) else list(seq)


def vjp(func, xs, v=None):
    """(func(xs), the vector-Jacobian product v^T J) with v ones by
    default; the product is one tensor for one input, else a list."""
    xs_l = [x.detach().requires_grad_() for x in _as_list(xs)]
    with torch.enable_grad():
        out = func(*xs_l)
        outs = _as_list(out)
        vs = [torch.ones_like(o) for o in outs] if v is None else _as_list(v)
        got = torch.autograd.grad(outs, xs_l, vs, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for g, x in zip(got, xs_l)]
    return _detach(out), _single(got, xs)


def _detach(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_detach(o) for o in out)
    return out.detach()


def jvp(func, xs, v=None):
    """(func(xs), the Jacobian-vector product J v) with v ones by default,
    by the double-backward trick of torch.autograd.functional.jvp."""
    xs_l = _as_list(xs)
    v_l = [torch.ones_like(x) for x in xs_l] if v is None else _as_list(v)
    out, tangent = torch.autograd.functional.jvp(
        lambda *a: func(*a), tuple(xs_l), tuple(v_l))
    return out, tangent


def _tape_jacobian(ys, xs):
    """jacobian(ys, xs) of a computed tensor: one backward pass a row, each
    input's gradient flattened -> (ys.numel(), x.numel()) per input."""
    xs_l = _as_list(xs)
    flat = ys.reshape(-1)
    rows = []
    for i in range(flat.numel()):
        gs = grad([flat[i]], xs_l, retain_graph=True, allow_unused=True)
        rows.append([torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
                     if g is None else g.reshape(-1)
                     for g, x in zip(gs, xs_l)])
    outs = [torch.stack([r[j] for r in rows]) for j in range(len(xs_l))]
    return _single(outs, xs)


def jacobian(func, xs, batch_axis=None):
    """The Jacobian of `func` at `xs`, shaped out.shape + x.shape (a tuple
    over inputs for a list of them). Given a computed tensor `ys` instead
    of a function, the Jacobian of ys with respect to xs by the tape,
    (ys.numel(), x.numel()) per input, as the reference's tape form."""
    if not callable(func):
        if isinstance(func, (list, tuple)):
            raise NotImplementedError("tensor-mode jacobian: single ys only")
        return _tape_jacobian(func, xs)
    if not isinstance(xs, (list, tuple)):
        return torch.autograd.functional.jacobian(func, xs)
    return torch.autograd.functional.jacobian(func, tuple(xs))


def hessian(func, xs, batch_axis=None):
    """The Hessian of the scalar `func` at `xs` (a tuple of tuples over
    input pairs for a list of inputs)."""
    if not isinstance(xs, (list, tuple)):
        return torch.autograd.functional.hessian(func, xs)
    return torch.autograd.functional.hessian(func, tuple(xs))

