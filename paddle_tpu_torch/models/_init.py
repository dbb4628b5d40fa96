"""Shared transformer weight-init policy (GPT-2 / BERT scheme). reference:
paddle_tpu/models/_init.py.

Weight matrices draw from N(0, initializer_range), truncated at 2 sigma for
BERT and plain for GPT-2; biases stay zero. The reference wraps the
initializer in a ParamAttr; the port's layers take the initializer itself
as `weight_attr`.
"""

from __future__ import annotations

from ..nn import initializer as I


def transformer_init_attr(std: float, truncated: bool = False):
    return (I.TruncatedNormal(mean=0.0, std=std) if truncated
            else I.Normal(0.0, std))
