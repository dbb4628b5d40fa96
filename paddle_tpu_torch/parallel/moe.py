"""Expert parallelism: GShard dispatch with the all-to-all over the 'ep'
mesh axis. reference: paddle_tpu/parallel/moe.py (`gshard_dispatch` :47,
`moe_dispatch_combine` :81, `ExpertParallelMoE` :148).

Capacity-bounded dispatch with static shapes: every (expert, capacity)
slot exists whether or not a token fills it, choice 0 of every token
queues first, and a token past its expert's capacity contributes zero.

The reference's ep path runs inside shard_map: each of the ep ranks
dispatches its T/ep tokens into its own [E, C, D] buffer, a tiled
all_to_all hands each rank its experts' slots from every rank, the rank's
E/ep experts run, and a second all_to_all brings the results home. The
port keeps the global view of distributed/placement.py: rank r's tokens
are block r of x (Shard(0) on ep) and its experts block r of the stacked
expert weights, and each all_to_all is a permutation of the ranks'
blocks. Expert e then runs once on all ep * C of its slots, as on its
rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

__all__ = ["moe_dispatch_combine", "ExpertParallelMoE", "gshard_dispatch"]


def gshard_dispatch(x, gate_logits, num_experts, capacity, top_k=2):
    """Local (single-shard) GShard dispatch. x: [T, D] tokens;
    gate_logits: [T, E]. Returns (dispatched [E, C, D], combine_weights
    [T, E, C], probs [T, E])."""
    t_count, d = x.shape
    probs = torch.softmax(gate_logits, dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)            # [T, k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # each (token, choice)'s place in its expert's queue, choice 0 of all
    # tokens first (GShard prioritises top-1)
    flat_exp = topi.transpose(0, 1).reshape(-1)              # [k*T]
    flat_gate = topv.transpose(0, 1).reshape(-1)
    onehot = F.one_hot(flat_exp, num_experts)                # [kT, E]
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = pos < capacity
    flat_gate = torch.where(keep, flat_gate, torch.zeros_like(flat_gate))
    pos = torch.clamp(pos, 0, capacity - 1)
    token_ids = torch.arange(t_count, device=x.device).repeat(top_k)
    dispatched = x.new_zeros((num_experts, capacity, d)).index_put(
        (flat_exp, pos), torch.where(keep[:, None], x[token_ids],
                                     torch.zeros((), dtype=x.dtype,
                                                 device=x.device)),
        accumulate=True)
    combine = x.new_zeros((t_count, num_experts, capacity)).index_put(
        (token_ids, flat_exp, pos), flat_gate.to(x.dtype), accumulate=True)
    return dispatched, combine, probs


def _expert(params, e):
    return pytree.tree_map(lambda w: w[e], params)


def dropped_choices(gate_logits, num_experts, capacity, top_k=2):
    """How many (token, choice) pairs gshard_dispatch drops at `capacity`
    (a host int)."""
    topi = torch.topk(torch.softmax(gate_logits, dim=-1), top_k,
                      dim=-1).indices
    onehot = F.one_hot(topi.transpose(0, 1).reshape(-1), num_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    return int((pos >= capacity).sum())


def moe_capacity(tokens, num_experts, capacity_factor, top_k):
    """Slots an expert holds for `tokens` tokens (the reference's formula)."""
    return max(1, int(math.ceil(top_k * tokens / num_experts
                                * capacity_factor)))


def moe_dispatch_combine(x, gate_logits, expert_apply, expert_params,
                         num_experts, mesh=None, axis_name="ep",
                         capacity_factor=1.25, top_k=2):
    """Full MoE: dispatch -> all-to-all -> experts -> all-to-all ->
    combine. x: [T, D]; gate_logits: [T, E]; expert_params: a pytree whose
    leaves have a leading expert dim E; expert_apply(params of one expert,
    tokens [C', D]) -> [C', D]. With `mesh` holding `axis_name`, the
    tokens split into ep blocks, each dispatched on its own with the
    capacity of T/ep tokens (E must divide by ep). Returns (out [T, D],
    probs [T, E])."""
    t_count, d = x.shape
    if mesh is None or axis_name not in mesh.dim_names:
        capacity = moe_capacity(t_count, num_experts, capacity_factor, top_k)
        dispatched, combine, probs = gshard_dispatch(
            x, gate_logits, num_experts, capacity, top_k)
        outs = torch.stack([expert_apply(_expert(expert_params, e),
                                         dispatched[e])
                            for e in range(num_experts)])    # [E, C, D]
        return torch.einsum("tec,ecd->td", combine, outs), probs

    ep = mesh.get_dim_size(axis_name)
    assert num_experts % ep == 0, "num_experts must divide the ep axis"
    e_local = num_experts // ep
    capacity = moe_capacity(t_count // ep, num_experts, capacity_factor,
                            top_k)
    shards = [gshard_dispatch(xs, ls, num_experts, capacity, top_k)
              for xs, ls in zip(x.chunk(ep), gate_logits.chunk(ep))]
    # all_to_all: rank r receives, from every source rank, the slots of
    # its experts r * e_local + i; expert e's ep * C slots in source order
    sent = torch.stack([s[0] for s in shards])               # [src, E, C, D]
    recv = sent.reshape(ep, ep, e_local, capacity, d).permute(1, 2, 0, 3, 4)
    recv = recv.reshape(num_experts, ep * capacity, d)
    outs = torch.stack([expert_apply(_expert(expert_params, e), recv[e])
                        for e in range(num_experts)])        # [E, ep*C, D]
    # back home: source rank r gets its slots of every expert
    back = outs.reshape(num_experts, ep, capacity, d).permute(1, 0, 2, 3)
    out = torch.cat([torch.einsum("tec,ecd->td", s[1], back[r])
                     for r, s in enumerate(shards)])
    return out, torch.cat([s[2] for s in shards])


class ExpertParallelMoE:
    """A functional EP-MoE block. params: gate [D, E]; w1 [E, D, H];
    w2 [E, H, D] (Shard(0) on ep); the experts are activation(x @ w1) @ w2
    with jax.nn.gelu's default, the tanh form."""

    def __init__(self, d_model, d_hidden, num_experts, mesh=None,
                 axis_name="ep", top_k=2, capacity_factor=1.25,
                 activation=None):
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.mesh = mesh
        self.axis_name = axis_name
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = activation or (
            lambda t: F.gelu(t, approximate="tanh"))

    def init(self, key, dtype=torch.float32, *, device=None):
        """Normal weights, gate and w1 scaled by 1/sqrt(d_model), w2 by
        1/sqrt(d_hidden). key: an int seed or a torch.Generator on the
        device (the port's default device if None)."""
        from ..framework.device import resolve_device
        device = resolve_device(device)
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=device).manual_seed(int(key))
        e, d, h = self.num_experts, self.d_model, self.d_hidden

        def normal(shape, scale):
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale
            return w.to(dtype)

        params = {"gate": normal((d, e), 1.0 / math.sqrt(d)),
                  "w1": normal((e, d, h), 1.0 / math.sqrt(d)),
                  "w2": normal((e, h, d), 1.0 / math.sqrt(h))}
        if self.mesh is not None and self.axis_name in self.mesh.dim_names:
            from ..distributed.placement import P, spec_to_placements
            for k in ("w1", "w2"):
                params[k].process_mesh = self.mesh
                params[k].placements = spec_to_placements(
                    P(self.axis_name), self.mesh, 3)
        return params

    def apply(self, params, x):
        """x: [T, D] -> ([T, D], the GShard load-balancing loss)."""
        logits = x @ params["gate"]

        def expert_apply(w, tokens):
            return self.activation(tokens @ w["w1"]) @ w["w2"]

        out, probs = moe_dispatch_combine(
            x, logits, expert_apply, {"w1": params["w1"], "w2": params["w2"]},
            self.num_experts, self.mesh, self.axis_name,
            self.capacity_factor, self.top_k)
        me = probs.mean(dim=0)                               # [E]
        ce = F.one_hot(logits.argmax(dim=-1), self.num_experts).to(
            probs.dtype).mean(dim=0)
        return out, self.num_experts * (me * ce).sum()
