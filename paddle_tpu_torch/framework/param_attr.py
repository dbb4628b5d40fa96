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

__all__ = ["ParamAttr", "L1Decay", "L2Decay"]


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
