"""MoE gates. reference: paddle_tpu/incubate/distributed/models/moe/gate.py
(`NaiveGate`, `GShardGate` with its aux loss on `.loss` :37-47,
`SwitchGate` :50).

Each gate is a Linear(d_model, num_expert) (`gate`, the reference's key)
whose softmax gives the experts' probabilities. SwitchGate adds noise
drawn from U(1 - eps, 1 + eps) to the logits in training, as the
reference adds it, from the port's generator of the logits' device.
"""

from __future__ import annotations

import torch

from .....framework.random import get_generator
from .....nn.functional import one_hot, softmax
from .....nn.layer.common import Linear
from .....nn.layer.layers import Layer

__all__ = ["NaiveGate", "GShardGate", "SwitchGate"]


class NaiveGate(Layer):
    def __init__(self, d_model, num_expert, world_size=1, top_k=2, *,
                 dtype="float32", device=None):
        super().__init__()
        self.top_k = top_k
        self.num_expert = num_expert
        self.gate = Linear(d_model, num_expert, dtype=dtype, device=device)

    def forward(self, x):
        return softmax(self.gate(x), axis=-1)


class GShardGate(NaiveGate):
    """NaiveGate with GShard's load-balancing loss on `.loss`: E times the
    sum over experts of the mean probability and the share of tokens
    whose top expert it is."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), group=None, *, dtype="float32",
                 device=None):
        super().__init__(d_model, num_expert, world_size, top_k,
                         dtype=dtype, device=device)
        self.loss = None

    def forward(self, x):
        probs = super().forward(x)
        e = probs.shape[-1]
        me = probs.mean(0)
        ce = one_hot(probs.argmax(-1), e).to(probs.dtype).mean(0)
        self.loss = (me * ce).sum() * e
        return probs


class SwitchGate(NaiveGate):
    """Top-1 gate; in training the logits get U(1 - eps, 1 + eps) noise."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, *,
                 dtype="float32", device=None):
        super().__init__(d_model, num_expert, world_size, 1, dtype=dtype,
                         device=device)
        self.eps = switch_eps
        self.loss = None

    def forward(self, x):
        logits = self.gate(x)
        if self.training:
            u = torch.rand(logits.shape, dtype=logits.dtype,
                           device=logits.device,
                           generator=get_generator(logits.device))
            logits = logits + (1 - self.eps) + 2 * self.eps * u
        return softmax(logits, axis=-1)
