"""paddle.static.nn: the static-graph layer builders. reference:
paddle_tpu/static/nn_builders.py, after python/paddle/static/nn/
(common.py fc:30, conv2d, batch_norm, embedding, ...; control_flow.py
case/switch_case; static_pylayer.py).

Each builder is a define-and-run call: it makes its parameters (honouring
param_attr/bias_attr as nn.Layer's create_parameter does) on its input's
device and applies its op at once. The parameters are the active
Program's: each is registered under `<base>.w_<i>` / `<base>.b_<i>`,
`base` an explicit `name` or `utils.unique_name.generate(kind)`, the
reference's names letter for letter, and a later call that resolves to
the same name REUSES the registered tensor (an explicitly named builder,
or one rebuilt under `utils.unique_name.guard()`). Unnamed calls outside
a guard make fresh parameters, as a second fc appended to a reference
Program would. `static.program_guard(p)` makes `p`'s registry the active
one.

The LoD sequence ops, sparse_embedding and nce raise, as the reference's
do.
"""

from __future__ import annotations

import torch

from ..framework.dtypes import convert_dtype
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.layers import _param
from ..utils import unique_name

__all__ = ["fc", "embedding", "conv2d", "conv3d", "conv2d_transpose",
           "conv3d_transpose", "deform_conv2d", "batch_norm", "layer_norm",
           "group_norm", "instance_norm", "data_norm", "prelu",
           "bilinear_tensor_product", "spectral_norm", "row_conv", "case",
           "switch_case", "py_func", "static_pylayer", "sequence_conv",
           "sequence_softmax", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_expand", "sparse_embedding", "nce",
           "reset_parameters"]

def _act(out, activation):
    if activation is None:
        return out
    fn = getattr(F, activation, None)
    if fn is None:
        raise ValueError(f"unknown activation {activation!r}")
    return fn(out)


#: resolved parameter name -> tensor: the active Program's parameters. It
#: accumulates as a reference Program does; reset_parameters() empties it.
_param_registry: dict = {}


def reset_parameters():
    """Forget every builder-made parameter (a fresh program)."""
    _param_registry.clear()


class _ParamFactory:
    """Named parameters of one builder call on `device`: each created
    tensor is registered under `<base>.<suffix>`, so that a later call
    with the same base reuses it."""

    def __init__(self, kind, name=None, device=None):
        self._base = name if name else unique_name.generate(kind)
        self._device = device
        self._n_w = 0
        self._n_b = 0

    def make(self, shape, attr=None, is_bias=False, default=None,
             dtype=None):
        # ParamAttr(name=...) shares a parameter between builders: it
        # overrides the positional key
        attr_name = getattr(attr, "name", None)
        if attr_name:
            key = attr_name
        elif is_bias:
            key = f"{self._base}.b_{self._n_b}"
            self._n_b += 1
        else:
            key = f"{self._base}.w_{self._n_w}"
            self._n_w += 1
        shape = tuple(int(s) for s in shape)
        hit = _param_registry.get(key)
        if hit is not None:
            if tuple(hit.shape) != shape:
                raise ValueError(
                    f"static.nn parameter {key!r} already exists with shape "
                    f"{tuple(hit.shape)}, requested {shape}; pass a "
                    "different name= or call static.nn.reset_parameters()")
            return hit
        p = _param(attr, default, shape, dtype or "float32", self._device,
                   is_bias)
        if p is None:  # attr=False: no parameter
            return None
        p.param_name = key
        _param_registry[key] = p
        return p

    def buffer(self, key_suffix, value, explicit_name=None):
        """Non-trainable persistent state (batch_norm's moving stats)."""
        key = explicit_name or f"{self._base}.{key_suffix}"
        hit = _param_registry.get(key)
        if hit is not None:
            if tuple(hit.shape) != tuple(value.shape):
                raise ValueError(
                    f"static.nn buffer {key!r} already exists with shape "
                    f"{tuple(hit.shape)}, requested {tuple(value.shape)}; "
                    "pass a different name or call "
                    "static.nn.reset_parameters()")
            return hit
        t = value.to(self._device)
        t.param_name = key
        _param_registry[key] = t
        return t


def _pair(k, n):
    return tuple(k) if isinstance(k, (list, tuple)) else (k,) * n


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Flatten the axes from num_flatten_dims on, a product with the
    weight, the bias, the activation."""
    pf = _ParamFactory("static_fc", name, x.device)
    xs = tuple(x.shape)
    if num_flatten_dims < 0:
        num_flatten_dims = len(xs) + num_flatten_dims
    in_features = 1
    for d in xs[num_flatten_dims:]:
        in_features *= int(d)
    w = pf.make((in_features, size), attr=weight_attr)
    b = pf.make((size,), attr=bias_attr, is_bias=True) \
        if bias_attr is not False else None
    out = x.reshape(xs[:num_flatten_dims] + (in_features,)) @ w
    if b is not None:
        out = out + b
    return _act(out, activation)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    pf = _ParamFactory("static_embedding", name, input.device)
    w = pf.make(tuple(size), attr=param_attr, dtype=dtype)
    return F.embedding(input, w, padding_idx=padding_idx, sparse=is_sparse)


def _conv_params(pf, input, num_filters, ks, groups, param_attr, bias_attr,
                 channel_axis, transpose=False):
    cin = int(input.shape[channel_axis])
    wshape = ((cin, num_filters // groups) if transpose
              else (num_filters, cin // groups)) + tuple(ks)
    w = pf.make(wshape, attr=param_attr)
    b = pf.make((num_filters,), attr=bias_attr, is_bias=True) \
        if bias_attr is not False else None
    return w, b


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    pf = _ParamFactory("static_conv2d", name, input.device)
    w, b = _conv_params(pf, input, num_filters, _pair(filter_size, 2),
                        groups, param_attr, bias_attr,
                        1 if data_format == "NCHW" else -1)
    out = F.conv2d(input, w, bias=b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCDHW"):
    pf = _ParamFactory("static_conv3d", name, input.device)
    w, b = _conv_params(pf, input, num_filters, _pair(filter_size, 3),
                        groups, param_attr, bias_attr,
                        1 if data_format == "NCDHW" else -1)
    out = F.conv3d(input, w, bias=b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    pf = _ParamFactory("static_conv2d_transpose", name, input.device)
    if filter_size is None:
        raise ValueError("filter_size is required (output_size-only "
                         "inference is not supported)")
    w, b = _conv_params(pf, input, num_filters, _pair(filter_size, 2),
                        groups, param_attr, bias_attr,
                        1 if data_format == "NCHW" else -1, transpose=True)
    out = F.conv2d_transpose(input, w, bias=b, stride=stride, padding=padding,
                             dilation=dilation, groups=groups,
                             output_size=output_size, data_format=data_format)
    return _act(out, act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCDHW"):
    pf = _ParamFactory("static_conv3d_transpose", name, input.device)
    if filter_size is None:
        raise ValueError("filter_size is required")
    w, b = _conv_params(pf, input, num_filters, _pair(filter_size, 3),
                        groups, param_attr, bias_attr,
                        1 if data_format == "NCDHW" else -1, transpose=True)
    out = F.conv3d_transpose(input, w, bias=b, stride=stride, padding=padding,
                             dilation=dilation, groups=groups,
                             output_size=output_size, data_format=data_format)
    return _act(out, act)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    """vision.ops.deform_conv2d with fresh parameters (modulated when
    `mask` is given)."""
    from ..vision.ops import deform_conv2d as _dc
    pf = _ParamFactory("static_deform_conv2d", name, input.device)
    w, b = _conv_params(pf, input, num_filters, _pair(filter_size, 2),
                        groups, param_attr, bias_attr, 1)
    return _dc(input, offset, w, bias=b, stride=stride, padding=padding,
               dilation=dilation, deformable_groups=deformable_groups,
               groups=groups, mask=mask)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """Scale, bias and the moving statistics, made and applied in one
    call; in training the moving statistics move in place."""
    pf = _ParamFactory("static_batch_norm", name, input.device)
    c = int(input.shape[1 if data_layout == "NCHW" else -1])
    scale = pf.make((c,), attr=param_attr, default=I.Constant(1.0))
    bias = pf.make((c,), attr=bias_attr, is_bias=True)
    mean = pf.buffer("moving_mean", torch.zeros(c, dtype=torch.float32),
                     explicit_name=moving_mean_name)
    var = pf.buffer("moving_variance", torch.ones(c, dtype=torch.float32),
                    explicit_name=moving_variance_name)
    out = F.batch_norm(input, mean, var, weight=scale, bias=bias,
                       training=not (is_test or use_global_stats),
                       momentum=momentum, epsilon=epsilon,
                       data_format=data_layout)
    return _act(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    pf = _ParamFactory("static_layer_norm", name, input.device)
    shape = tuple(int(s) for s in input.shape[begin_norm_axis:])
    w = pf.make(shape, attr=param_attr, default=I.Constant(1.0)) \
        if scale else None
    b = pf.make(shape, attr=bias_attr, is_bias=True) if shift else None
    out = F.layer_norm(input, shape, weight=w, bias=b, epsilon=epsilon)
    return _act(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    pf = _ParamFactory("static_group_norm", name, input.device)
    c = int(input.shape[1 if data_layout == "NCHW" else -1])
    w = pf.make((c,), attr=param_attr, default=I.Constant(1.0))
    b = pf.make((c,), attr=bias_attr, is_bias=True)
    out = F.group_norm(input, groups, epsilon=epsilon, weight=w, bias=b,
                       data_format=data_layout)
    return _act(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    pf = _ParamFactory("static_instance_norm", name, input.device)
    c = int(input.shape[1])
    w = pf.make((c,), attr=param_attr, default=I.Constant(1.0)) \
        if param_attr is not False else None
    b = pf.make((c,), attr=bias_attr, is_bias=True) \
        if bias_attr is not False else None
    return F.instance_norm(input, weight=w, bias=b, eps=epsilon)


def _batch_standardize(a, epsilon):
    var, mean = torch.var_mean(a, dim=0, keepdim=True, correction=0)
    return (a - mean) / torch.sqrt(var + epsilon)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              summary_decay_rate=0.9999999, sync_stats=False,
              enable_scale_and_shift=False):
    """Each feature (column) normalized by the batch's mean and population
    variance; with enable_scale_and_shift a learned scale and bias."""
    out = _batch_standardize(input, epsilon)
    if enable_scale_and_shift:
        pf = _ParamFactory("static_data_norm", name, input.device)
        c = int(input.shape[-1])
        scale_w = pf.make((c,), attr=param_attr, default=I.Constant(1.0))
        bias = pf.make((c,), is_bias=True)
        out = out * scale_w + bias
    return _act(out, act)


def prelu(x, mode, param_attr=None, data_format="NCHW", name=None):
    """PReLU with one weight ("all"), one per channel ("channel") or one
    per element of a sample ("element")."""
    pf = _ParamFactory("static_prelu", name, x.device)
    if mode == "all":
        shape = (1,)
    elif mode == "channel":
        shape = (int(x.shape[1 if data_format == "NCHW" else -1]),)
    elif mode == "element":
        shape = tuple(int(s) for s in x.shape[1:])
    else:
        raise ValueError(f"prelu mode must be all/channel/element, got {mode}")
    w = pf.make(shape, attr=param_attr, default=I.Constant(0.25))
    if mode == "channel":
        return F.prelu(x, w, data_format=data_format)
    if mode == "element":
        return torch.where(x > 0, x, x * w[None])
    return F.prelu(x, w)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out[:, k] = x W_k yᵀ + b_k."""
    pf = _ParamFactory("static_bilinear_tensor_product", name, x.device)
    dx, dy = int(x.shape[1]), int(y.shape[1])
    w = pf.make((size, dx, dy), attr=param_attr)
    b = pf.make((size,), attr=bias_attr, is_bias=True) \
        if bias_attr is not False else None
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if b is not None:
        out = out + b
    return _act(out, act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """weight over its largest singular value by power iteration, started
    from the same vector of ones at every call."""
    wm = torch.movedim(weight, dim, 0).reshape(weight.shape[dim], -1)
    u = torch.ones(wm.shape[0], dtype=weight.dtype,
                   device=weight.device) / (wm.shape[0] ** 0.5)
    for _ in range(max(power_iters, 1)):
        v = wm.T @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.norm(u) + eps)
    return weight / (u @ wm @ v)


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead convolution (Deep Speech 2): out[:, t] = sum over
    i = 0..k of in[:, t + i] * w[i]."""
    pf = _ParamFactory("static_row_conv", name, input.device)
    k = future_context_size
    w = pf.make((k + 1, int(input.shape[-1])), attr=param_attr)
    T = input.shape[1]
    out = torch.zeros_like(input)
    for i in range(k + 1):
        out = out + torch.nn.functional.pad(
            input[:, i:, :] * w[i], (0, 0, 0, min(i, T)))
    return _act(out, act)


# -- control flow -----------------------------------------------------------

def case(pred_fn_pairs, default=None, name=None):
    """The fn of the first pair whose predicate holds; past the last pair,
    `default`, or without one the last pair's fn."""
    from . import cond as _cond
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")

    def build(pairs):
        (pred, fn) = pairs[0]
        rest = pairs[1:]
        if not rest:
            if default is None:
                return fn()
            return _cond(pred, fn, default)
        return _cond(pred, fn, lambda: build(rest))

    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch whose key equals branch_index (read on the host); else
    `default`, or without one the branch with the largest key."""
    items = (sorted(branch_fns.items()) if isinstance(branch_fns, dict)
             else list(enumerate(branch_fns)))
    idx = int(branch_index.reshape(()).item()) \
        if isinstance(branch_index, torch.Tensor) else int(branch_index)
    fns = dict(items)
    if idx in fns:
        fn = fns[idx]
    else:
        fn = default if default is not None else items[-1][1]
    out = fn()
    return out if isinstance(out, torch.Tensor) else torch.as_tensor(out)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """func on the inputs as numpy arrays, on the host; its results as
    tensors of `out`'s shapes and dtypes on the first input's device."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    device = next((t.device for t in xs if isinstance(t, torch.Tensor)),
                  None)
    r = func(*[t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
               else t for t in xs])
    rs = r if isinstance(r, (list, tuple)) else [r]
    res = []
    for v, o in zip(rs, outs):
        t = torch.as_tensor(v).to(device=device, dtype=convert_dtype(o.dtype))
        if tuple(t.shape) != tuple(o.shape):
            raise ValueError(f"py_func: result of shape {tuple(t.shape)}, "
                             f"declared {tuple(o.shape)}")
        res.append(t)
    return res if isinstance(out, (list, tuple)) else res[0]


def static_pylayer(forward_fn, inputs, backward_fn=None, name=None):
    """A custom forward and backward pair, as an autograd.PyLayer."""
    from ..autograd import PyLayer

    class _P(PyLayer):
        @staticmethod
        def forward(ctx, *args):
            return forward_fn(*args)

        @staticmethod
        def backward(ctx, *grads):
            if backward_fn is None:
                raise RuntimeError("static_pylayer: no backward_fn given")
            return backward_fn(*grads)

    return _P.apply(*inputs)


# -- the legacy LoD sequence and parameter-server ops raise ------------------

def _lod_descoped(op):
    def fn(*a, **k):
        raise NotImplementedError(
            f"paddle.static.nn.{op}: the LoD sequence ops serve the legacy "
            "variable-length pipeline, which the reference does not have "
            "either; use dense padded tensors with masks")
    fn.__name__ = op
    return fn


sequence_conv = _lod_descoped("sequence_conv")
sequence_softmax = _lod_descoped("sequence_softmax")
sequence_pool = _lod_descoped("sequence_pool")
sequence_first_step = _lod_descoped("sequence_first_step")
sequence_last_step = _lod_descoped("sequence_last_step")
sequence_expand = _lod_descoped("sequence_expand")


def sparse_embedding(*a, **k):
    raise NotImplementedError(
        "paddle.static.nn.sparse_embedding serves parameter-server "
        "training, which the reference does not have either; use "
        "static.nn.embedding")


def nce(*a, **k):
    raise NotImplementedError(
        "paddle.static.nn.nce (noise-contrastive estimation over a "
        "parameter-server sampler) is not in the reference either; use a "
        "full-softmax cross_entropy")
