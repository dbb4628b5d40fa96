"""nn.Layer, the base of every layer and model of the port. reference:
paddle_tpu/nn/layer/layers.py (`Layer` :34-306, `Sequential` :308,
`LayerList`, `LayerDict`, `ParameterList`) and the top-level
`create_parameter` (paddle_tpu/__init__.py:159).

`Layer` is a `torch.nn.Module` that adds the reference's API with the
reference's semantics: `create_parameter`, `add_parameter`,
`add_sublayer`, `parameters()` as a list, `named_sublayers`/`sublayers`,
`state_dict`/`set_state_dict`, forward pre- and post-hooks,
`clear_gradients`, `astype` and `full_name`. torch calls several of these
methods itself, so each also takes torch's own arguments:
`named_parameters`/`named_buffers` take `recurse` and `remove_duplicate`
(`torch.func.functional_call`, `torch.export`), `state_dict` takes
`prefix` and `keep_vars` (torch's recursion into a child), `register_buffer`
takes `persistent` beside the reference's `persistable`, `train(mode)` takes
the flag `eval()` passes, and `to(device, dtype, blocking)` keeps torch's
positional order.

`state_dict()` holds each parameter once, under its first name, as the
reference's deduplicating `named_parameters` does (:141-150): a weight tied
between two layers has one key. Parameters come first, then the persistable
buffers, in the reference's order. `load_state_dict` fills a tied
parameter's other names from the one the state holds.
"""

from __future__ import annotations

import collections

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.dtypes import NAME2DTYPE, convert_dtype
from ...framework.param_attr import ParamAttr
from ...framework.random import get_generator

__all__ = ["Layer", "LayerList", "ParameterList", "Sequential", "LayerDict"]


def _param(attr, default, shape, dtype, device, is_bias=False):
    """The reference's `create_parameter` (nn/layer/layers.py:48-80): None
    when `attr` is False; else drawn by `attr`'s initializer (a ParamAttr's
    or `attr` itself), or `default`, or the global initializer
    (`set_global_initializer`), or XavierUniform for a weight and zeros for
    a bias, in that order. The ParamAttr's `trainable` sets requires_grad,
    its `name` lands on `param_name` (torch's `Tensor.name` cannot be set),
    and `optimize_attr = {"learning_rate": lr}` (1.0 without a ParamAttr);
    the optimizers read both."""
    from .. import initializer as I
    if attr is False:
        return None
    init, trainable, name, lr = default, True, None, 1.0
    if isinstance(attr, ParamAttr):
        init = attr.initializer or default
        trainable, name, lr = attr.trainable, attr.name, attr.learning_rate
    elif attr is not None and attr is not True:
        init = attr
    if init is None:
        init = I._GLOBAL[1] if is_bias else I._GLOBAL[0]
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    device = resolve_device(device)
    data = init(tuple(int(s) for s in shape), convert_dtype(dtype), device,
                get_generator(device))
    p = nn.Parameter(data, requires_grad=trainable)
    p.param_name = name
    p.optimize_attr = {"learning_rate": lr}
    return p


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, *,
                     device=None):
    """A parameter of `shape` outside any layer: `default_initializer`,
    else zeros for a bias and XavierUniform for a weight (reference
    paddle_tpu/__init__.py:159-176)."""
    p = _param(attr, default_initializer, shape, dtype or "float32", device,
               is_bias)
    if name is not None:
        p.param_name = name
    return p


def _is_dtype(x):
    return isinstance(x, torch.dtype) or (isinstance(x, str)
                                          and x in NAME2DTYPE)


class Layer(nn.Module):
    """The reference's `Layer` on `torch.nn.Module`."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- construction -------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None):
        """A parameter of `shape` in `dtype` (the layer's by default) on
        `device` (the port's default device), not yet registered: assign
        it to an attribute or pass it to `add_parameter`."""
        return _param(attr, default_initializer, shape, dtype or self._dtype,
                      device, is_bias)

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """A buffer saved in `state_dict` when persistable (torch's
        `persistent`, which wins when both are given)."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=keep)
        return tensor

    # -- traversal ----------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        """(name, parameter) pairs, each parameter once by default."""
        rec = include_sublayers if recurse is None else recurse
        yield from super().named_parameters(
            prefix=prefix, recurse=rec, remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None):
        """The parameters as a list, as the reference returns them."""
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, *,
                      recurse=None, remove_duplicate=True):
        rec = include_sublayers if recurse is None else recurse
        yield from super().named_buffers(
            prefix=prefix, recurse=rec, remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(name, layer) pairs in pre-order, each layer once."""
        for name, m in self.named_modules(memo=layers_set, prefix=prefix):
            if include_self or m is not self:
                yield name, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def children(self):
        return [m for m in self._modules.values() if m is not None]

    def named_children(self):
        return [(n, m) for n, m in self._modules.items() if m is not None]

    # -- dtype, device -------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """torch's `to` under the reference's names: a dtype may come first
        (`to(torch.bfloat16)`, `to("bfloat16")`), `blocking=False` is torch's
        non_blocking. Only floating parameters and buffers change dtype."""
        if _is_dtype(device):
            device, dtype = None, device
        if isinstance(device, torch.Tensor):
            return super().to(device, **kwargs)
        if dtype is not None:
            kwargs["dtype"] = convert_dtype(dtype)
        if device is not None:
            kwargs["device"] = device
        if blocking is False:
            kwargs["non_blocking"] = True
        return super().to(**kwargs) if kwargs else self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        """Each parameter once under its first name, then each persistable
        buffer; detached unless `keep_vars`."""
        if destination is None:
            destination = collections.OrderedDict()
        pre = structured_name_prefix if prefix is None else prefix
        pre = pre[:-1] if pre.endswith(".") else pre
        for name, p in self.named_parameters(pre, include_sublayers):
            destination[name] = p if keep_vars else p.detach()
        seen = set()
        for mname, m in self.named_modules(prefix=pre):
            if not include_sublayers and m is not self:
                continue
            for bname, b in m._buffers.items():
                if (b is None or id(b) in seen
                        or bname in m._non_persistent_buffers_set):
                    continue
                seen.add(id(b))
                key = mname + "." + bname if mname else bname
                destination[key] = b if keep_vars else b.detach()
        return destination

    def _tied_names(self):
        """{other name: first name} of every parameter held under more than
        one name."""
        first, out = {}, {}
        for name, p in self.named_parameters(remove_duplicate=False):
            if id(p) in first:
                out[name] = first[id(p)]
            else:
                first[id(p)] = name
        return out

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """torch's load, with a tied parameter's other names filled from the
        name `state_dict()` gives it."""
        state = collections.OrderedDict(state_dict)
        for alias, name in self._tied_names().items():
            if alias not in state and name in state:
                state[alias] = state[name]
        return super().load_state_dict(state, strict=strict, assign=assign)

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of `state_dict` (tensors or arrays) into the
        tensor of that name, cast to its dtype and reshaped to its shape.
        Returns (missing, unexpected) names, as the reference does."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        for name, t in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            v = torch.as_tensor(state_dict[name])
            t.copy_(v.to(device=t.device, dtype=t.dtype).reshape(t.shape))
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- hooks --------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, output); a non-None return replaces the
        output. The handle's `remove()` takes it off."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._name_scope


class Sequential(Layer, nn.Sequential):
    """Layers called in order, named "0", "1", ... as given, or by the
    keys of one OrderedDict, or by the names of (name, layer) tuples.
    Also a torch.nn.Sequential."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)


class LayerList(Layer, nn.ModuleList):
    """A list of layers, named "0", "1", ...; also a torch.nn.ModuleList
    (indexing, slicing, append, insert, extend)."""

    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)


class LayerDict(Layer):
    """An ordered dict of layers under their keys."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        items = (sublayers.items() if isinstance(sublayers, dict)
                 else sublayers)
        for k, v in items:
            self[k] = v

    def pop(self, key):
        layer = self._modules[key]
        del self._modules[key]
        return layer

    def clear(self):
        self._modules.clear()


class ParameterList(Layer):
    """A list of parameters, named "0", "1", ..."""

    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx if idx >= 0 else len(self) + idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
