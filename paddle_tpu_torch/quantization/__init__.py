"""Quantization: quantization-aware training (QAT) and post-training
quantization (PTQ). reference: paddle_tpu/quantization/__init__.py
(`_fake_quant` :25, the observers :40-86, the quanters :89-118,
`_SingleLayerConfig`/`QuantConfig` :121-157, `QuantedLinear`/
`QuantedConv2D` :188-212, `_wrap_model` :217, `QAT` :236, `PTQ` :260,
`quanter` :331).

Quantization here is simulated (quantize, then dequantize) with a
straight-through gradient, as in the reference. Observers keep their
running scale in a float32 buffer `_scale`, so state-dict keys equal the
reference's (`fc1.weight_quanter._observer._scale`, ...) and
convert.load_reference_state carries calibrated scales across.

A quanter or observer built by a config follows the device of the layer it
wraps; one built by hand takes `device=` (default: the package's).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .. import nn as pnn
from ..framework.device import resolve_device
from ..nn import functional as F
from ..nn.quant.format import div
from ..nn.layer.layers import Layer

__all__ = ["QuantConfig", "QAT", "PTQ", "BaseQuanter", "BaseObserver",
           "AbsmaxObserver", "EMAObserver", "FakeQuanterWithAbsMaxObserver",
           "quanted_layers"]


def _fake_quant(x, scale, bits=8):
    """Quantize-dequantize with a straight-through gradient. A zero scale
    (an observer that has seen nothing) passes x through unquantized."""
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(scale, min=1e-8)
    q = div(torch.clamp(torch.round(x / s * qmax), -qmax, qmax) * s, qmax)
    q = torch.where(scale > 0, q, x)
    return x + (q - x).detach()


class BaseObserver(Layer):
    """An observer: the identity that records a scale of what it sees."""

    def __init__(self, quant_bits=8, *, device=None):
        super().__init__()
        self._quant_bits = quant_bits
        self.register_buffer("_scale", torch.zeros(
            (), dtype=torch.float32, device=resolve_device(device)))

    def scales(self):
        return self._scale

    def bit_length(self):
        return self._quant_bits

    def quant_axis(self):
        return -1

    def _observe(self, x):
        raise NotImplementedError

    def forward(self, x):
        self._observe(x)
        return x


class AbsmaxObserver(BaseObserver):
    """The running max of |x|."""

    @torch.no_grad()
    def _observe(self, x):
        cur = x.detach().abs().max().float()
        self._scale.copy_(torch.maximum(self._scale, cur))


class EMAObserver(BaseObserver):
    """An exponential moving average of each batch's max |x|; the first
    batch sets it."""

    def __init__(self, quant_bits=8, moving_rate=0.9, *, device=None):
        super().__init__(quant_bits, device=device)
        self._rate = moving_rate

    @torch.no_grad()
    def _observe(self, x):
        cur = x.detach().abs().max().float()
        prev = self._scale
        self._scale.copy_(torch.where(
            prev == 0, cur, self._rate * prev + (1 - self._rate) * cur))


class BaseQuanter(Layer):
    """The base of quanters (the reference's takes a Layer's name_scope and
    dtype, and ignores them here)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()


class FakeQuanterWithAbsMaxObserver(BaseQuanter):
    """The QAT quanter: an EMA absmax observer, observing only in
    training, and fake quantization at its scale."""

    def __init__(self, moving_rate=0.9, quant_bits=8, dtype="float32", *,
                 device=None):
        super().__init__()
        self._observer = EMAObserver(quant_bits, moving_rate, device=device)
        self._quant_bits = quant_bits

    def scales(self):
        return self._observer.scales()

    def bit_length(self):
        return self._quant_bits

    def forward(self, x):
        if self.training:
            self._observer._observe(x)
        return _fake_quant(x, self._observer._scale, self._quant_bits)


class _SingleLayerConfig:
    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight


class QuantConfig:
    """The quanters (or observers) of activations and weights: for a given
    layer object, for a layer type, or for every layer, in that order of
    precedence."""

    def __init__(self, activation=None, weight=None):
        self._global = _SingleLayerConfig(activation, weight)
        self._layer_configs = []   # (layer, config), matched by identity
        self._type_configs = []    # (layer type, config)

    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for one in layers:
            self._layer_configs.append(
                (one, _SingleLayerConfig(activation, weight)))

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = (layer_type if isinstance(layer_type, (list, tuple))
                 else [layer_type])
        for t in types:
            self._type_configs.append(
                (t, _SingleLayerConfig(activation, weight)))

    def _config_for(self, layer):
        for one, cfg in self._layer_configs:
            if layer is one:
                return cfg
        for t, cfg in self._type_configs:
            if isinstance(layer, t):
                return cfg
        if self._global.activation or self._global.weight:
            return self._global
        return None


def _make(factory, device):
    """A quanter or observer from its factory, on `device`: a class is
    built there, any other callable's result moved there."""
    if isinstance(factory, type):
        return factory(device=device)
    return factory().to(device)


def _device_of(layer):
    return next(iter(layer.parameters())).device


class _QuantedBase(Layer):
    """A layer with its weight and input quanters; each quanter is set
    only when configured."""

    def __init__(self, inner, cfg):
        super().__init__()
        self._inner = inner
        device = _device_of(inner)
        if cfg.weight:
            self.weight_quanter = _make(cfg.weight, device)
        if cfg.activation:
            self.activation_quanter = _make(cfg.activation, device)

    @property
    def _wq(self):
        return getattr(self, "weight_quanter", None)

    @property
    def _aq(self):
        return getattr(self, "activation_quanter", None)


class QuantedLinear(_QuantedBase):
    def forward(self, x):
        w = self._inner.weight
        if self._wq is not None:
            w = self._wq(w)
        if self._aq is not None:
            x = self._aq(x)
        return F.linear(x, w, self._inner.bias)


class QuantedConv2D(_QuantedBase):
    def forward(self, x):
        inner = self._inner
        w = inner.weight
        if self._wq is not None:
            w = self._wq(w)
        if self._aq is not None:
            x = self._aq(x)
        return F.conv2d(x, w, inner.bias, inner._stride, inner._padding,
                        inner._dilation, inner._groups, inner._data_format)


quanted_layers = {pnn.Linear: QuantedLinear, pnn.Conv2D: QuantedConv2D}


def _wrap_model(model, config, wrap, original=None):
    """Replace each configured layer of `model` (possibly a deepcopy) by
    `wrap(cls, layer, cfg)`, walking `original` in lock step so that
    identity-keyed layer configs still resolve after the copy."""
    original = original if original is not None else model
    for name, sub in list(model._modules.items()):
        if sub is None:
            continue
        orig_sub = original._modules.get(name, sub)
        cfg = config._config_for(orig_sub)
        cls = quanted_layers.get(type(sub))
        if cfg is not None and cls is not None:
            model._modules[name] = wrap(cls, sub, cfg)
        else:
            _wrap_model(sub, config, wrap, orig_sub)
    return model


class QAT:
    """Quantization-aware training: each configured layer becomes its
    Quanted* form, whose quanters observe in training and fake-quantize."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model, inplace=False):
        original = model
        if not inplace:
            model = copy.deepcopy(model)
        return _wrap_model(model, self._config,
                           lambda cls, sub, cfg: cls(sub, cfg),
                           original=original)

    def convert(self, model, inplace=False):
        """Freeze the observers (eval mode) for export."""
        if not inplace:
            model = copy.deepcopy(model)
        model.eval()
        return model


class _Observed(Layer):
    """A layer under PTQ calibration: its input observer sees every batch;
    its weight observer saw the (static) weight once."""

    def __init__(self, inner, cfg):
        super().__init__()
        self._inner = inner
        device = _device_of(inner)
        self.act_observer = (_make(cfg.activation, device)
                             if cfg.activation else None)
        self.w_observer = _make(cfg.weight, device) if cfg.weight else None
        if self.w_observer is not None:
            self.w_observer(inner.weight)

    def forward(self, x):
        if self.act_observer is not None:
            x = self.act_observer(x)
        return self._inner(x)


def _frozen_quanter(observer):
    """A FakeQuanterWithAbsMaxObserver in eval mode at `observer`'s scale."""
    fq = FakeQuanterWithAbsMaxObserver(quant_bits=observer.bit_length(),
                                       device=observer._scale.device)
    with torch.no_grad():
        fq._observer._scale.copy_(observer._scale)
    return fq.eval()


class PTQ:
    """Post-training quantization: observe calibration batches, then
    convert each observed layer to its Quanted* form with frozen
    fake-quanters at the calibrated scales."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model, inplace=False):
        original = model
        if not inplace:
            model = copy.deepcopy(model)
        return _wrap_model(model, self._config,
                           lambda cls, sub, cfg: _Observed(sub, cfg),
                           original=original)

    def convert(self, model, inplace=False):
        if not inplace:
            model = copy.deepcopy(model)

        def walk(m):
            for name, sub in list(m._modules.items()):
                if sub is None:
                    continue
                if isinstance(sub, _Observed):
                    inner = sub._inner
                    q = quanted_layers[type(inner)](
                        inner, _SingleLayerConfig(None, None))
                    if sub.w_observer is not None:
                        q.weight_quanter = _frozen_quanter(sub.w_observer)
                    if sub.act_observer is not None:
                        q.activation_quanter = _frozen_quanter(
                            sub.act_observer)
                    m._modules[name] = q
                else:
                    walk(sub)

        walk(model)
        model.eval()
        return model


_QUANTER_REGISTRY = {}


def quanter(name):
    """Class decorator: register a quanter under `name` as an export of
    this module (a name already exported raises)."""
    def deco(cls):
        existing = globals().get(name)
        if existing is not None and existing is not cls:
            raise ValueError(
                f"quanter name {name!r} collides with an existing "
                "paddle_tpu_torch.quantization export; pick another name")
        globals()[name] = cls
        _QUANTER_REGISTRY[name] = cls
        return cls
    return deco
