"""The MoE layer. reference:
paddle_tpu/incubate/distributed/models/moe/__init__.py (`MoELayer`
:25-66).

The forward is the reference's dense form: every expert runs on every
token, the gate's top-k probabilities are renormalised to sum to 1, and
the experts' outputs are combined by a one-hot of the top-k indices. It
spends E / k times the useful expert flops (4x at 8 experts, top-2);
routing tokens to their experts is not ported.
"""

from __future__ import annotations

import torch

from .....nn.functional import one_hot
from .....nn.layer.layers import Layer, LayerList
from . import gate  # noqa: F401
from .gate import GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "GShardGate", "SwitchGate", "NaiveGate"]


class MoELayer(Layer):
    """Experts (a list of layers of d_model -> d_model) behind a gate (a
    float32 NaiveGate of top_k on the experts' device unless given one).
    The combine runs in the promoted dtype of the experts' outputs and the
    gate's probabilities, as jnp.einsum promotes them."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, top_k=2, **kwargs):
        super().__init__()
        self.d_model = d_model
        if isinstance(gate, dict):
            top_k = gate.get("top_k", top_k)
            gate = None
        self.top_k = top_k
        self.experts = experts if isinstance(experts, LayerList) else \
            LayerList(experts)
        self.num_experts = len(self.experts)
        if gate is None:
            p = self.experts[0].parameters()[0]
            gate = NaiveGate(d_model, self.num_experts, top_k=top_k,
                             device=p.device)
        self.gate = gate

    def forward(self, x):
        orig_shape = x.shape
        h = x.reshape(-1, self.d_model)
        scores = self.gate(h)                            # (tokens, E)
        topv, topi = torch.topk(scores, self.top_k, dim=-1)
        stacked = torch.stack([e(h) for e in self.experts], 1)  # (t, E, d)
        dt = torch.promote_types(stacked.dtype, scores.dtype)
        onehot = one_hot(topi, self.num_experts).to(dt)
        norm = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        w = torch.einsum("tke,tk->te", onehot, norm.to(dt))
        return torch.einsum("ted,te->td", stacked.to(dt), w).reshape(
            orig_shape)
