"""ParamAttr and the decay objects. A copy of
paddle_tpu/framework/param_attr.py (:9-34; reference:
python/paddle/base/param_attr.py, python/paddle/regularizer.py).

A layer built with a `ParamAttr` takes its initializer, `trainable` and
`name`, and sets the parameter's `optimize_attr = {"learning_rate": lr}`,
which the optimizers multiply into their learning rate
(nn/layer/common._param). As in the reference, no optimizer reads
`regularizer`; a decay object passed as an optimizer's `weight_decay` is
applied as coeff * p, L1Decay included.
"""

from __future__ import annotations

import torch

from .dtypes import convert_dtype

__all__ = ["ParamAttr", "L1Decay", "L2Decay", "Parameter"]


class Parameter(torch.nn.Parameter):
    """paddle.Parameter (EagerParamBase): a torch Parameter made from data
    as Paddle makes one, (data, dtype, name, trainable); the name lands on
    `param_name`, as a layer's do (nn/layer/layers.py)."""

    def __new__(cls, data=None, dtype=None, name=None, trainable=True):
        t = data.detach() if isinstance(data, torch.Tensor) else \
            torch.as_tensor(data)
        if dtype is not None:
            t = t.to(convert_dtype(dtype))
        p = super().__new__(cls, t, requires_grad=trainable)
        p.param_name = name
        return p


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff

    def __float__(self):
        return float(self._coeff)


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff

    def __float__(self):
        return float(self._coeff)
