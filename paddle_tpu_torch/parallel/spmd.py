"""The mesh trainer: hybrid parallelism as sharding rules. reference:
paddle_tpu/parallel/spmd.py (`create_mesh` :31, the rules :46-67,
`spec_for`, `shard_params_by_rules` :90-99, `_with_zero_axis` :102,
`SpmdTrainer` :118-281).

The reference compiles one GSPMD step whose parameters, gradients and
optimizer states carry NamedShardings. The port keeps its global view:
every tensor holds its whole value on the mesh's device and carries the
placements the reference's sharding would have (distributed/placement.py),
so the chunk map of each parameter and state is the reference's sharding,
stage by stage, while the arithmetic is the same at every stage and on
every mesh. The step is the port's eager training step: the loss through
`make_loss_fn`, gradients by autograd, the clip as the functional mirror of
nn.ClipGradBy*, and the optimizer's in-place `tree_update`.

Mesh axes follow the reference's fixed order pp→mp→sep→sharding→dp
(fleet/base/topology.py:301) so configs translate 1:1.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.placement import (P, ProcessMesh, chunk_map,
                                     spec_to_placements)
from ..framework.random import get_generator
from .functional import make_loss_fn

__all__ = ["create_mesh", "shard_params_by_rules", "SpmdTrainer",
           "LLAMA_SHARDING_RULES", "GPT_SHARDING_RULES", "DP_ONLY_RULES"]


def create_mesh(dp=1, mp=1, pp=1, sep=1, sharding=1, devices=None, *,
                device=None) -> ProcessMesh:
    """The hybrid mesh (axis order = reference fleet order) over
    dp*mp*pp*sep*sharding process ids, on `device` (the port's default if
    None). `devices`, a list of process ids, must hold at least that many;
    they need not be distinct cards (placement.py)."""
    need = dp * mp * pp * sep * sharding
    ids = np.arange(need) if devices is None else np.asarray(devices)
    if len(ids) < need:
        raise ValueError(f"need {need} devices, have {len(ids)}")
    grid = ids[:need].reshape(pp, mp, sep, sharding, dp)
    return ProcessMesh(grid, ["pp", "mp", "sep", "sharding", "dp"],
                       device=device)


# -- sharding rules: (param-name regex → PartitionSpec) ----------------------
# Megatron column-parallel weights shard their output dim on mp,
# row-parallel weights their input dim.

LLAMA_SHARDING_RULES = [
    (r".*embed_tokens\.weight$", P("mp", None)),           # vocab-parallel
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", P(None, "mp")),
    (r".*(o_proj|down_proj)\.weight$", P("mp", None)),
    (r".*lm_head\.weight$", P(None, "mp")),
    (r".*norm.*\.weight$", P()),                            # replicated
    (r".*", P()),
]

GPT_SHARDING_RULES = [
    (r".*(wte|wpe)\.weight$", P("mp", None)),
    (r".*qkv_proj\.weight$", P(None, "mp")),
    (r".*qkv_proj\.bias$", P("mp")),
    (r".*out_proj\.weight$", P("mp", None)),
    (r".*fc1\.weight$", P(None, "mp")),
    (r".*fc1\.bias$", P("mp")),
    (r".*fc2\.weight$", P("mp", None)),
    (r".*", P()),
]

DP_ONLY_RULES = [(r".*", P())]


def spec_for(name: str, rules) -> P:
    for pat, spec in rules:
        if re.match(pat, name):
            return spec
    return P()


def _pad_spec(spec, ndim: int) -> P:
    parts = list(spec) + [None] * (ndim - len(list(spec)))
    return P(*parts[:ndim])


def _axis_size(mesh, s):
    names = (s,) if isinstance(s, str) else tuple(s)
    return int(np.prod([mesh.get_dim_size(x) for x in names]))


def _place(t, mesh, spec):
    """Mark `t` with the placements of `spec` on `mesh`; keep the spec."""
    t.process_mesh = mesh
    t.placements = spec_to_placements(spec, mesh, t.ndim)
    chunk_map(mesh, t.placements, t.shape)
    t.partition_spec = _pad_spec(spec, t.ndim)
    return t


def shard_params_by_rules(params: dict, mesh: ProcessMesh, rules) -> dict:
    """name -> tensor dict laid out on `mesh` per `rules`: each a copy on
    the mesh's device marked with its placements, an axis dropped from a
    dim it does not divide (tiny test shapes)."""
    out = {}
    for name, a in params.items():
        spec = _pad_spec(spec_for(name, rules), a.ndim)
        fixed = [s if s is None or a.shape[dim] % _axis_size(mesh, s) == 0
                 else None for dim, s in enumerate(spec)]
        t = a.detach().to(mesh.device, copy=True)
        out[name] = _place(t, mesh, P(*fixed))
    return out


def _with_zero_axis(spec, shape, mesh: ProcessMesh,
                    axis: str = "sharding") -> P:
    """Add the ZeRO 'sharding' axis to the first unsharded, divisible dim
    (the reference's partition of flat parameter shards by rank,
    group_sharded_stage3.py:85, as a dimension sharding)."""
    n = mesh.get_dim_size(axis)
    parts = list(spec) + [None] * (len(shape) - len(list(spec)))
    for dim, s in enumerate(parts):
        if s is None and shape[dim] % n == 0 and shape[dim] >= n:
            parts[dim] = axis
            return P(*parts)
    return P(*parts)


def _clip(grad_clip, grads):
    """Functional mirror of nn.ClipGradBy* (the eager path clips in
    Optimizer.step), over a list of gradients."""
    from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                           ClipGradByValue)
    if grad_clip is None:
        return grads
    if isinstance(grad_clip, ClipGradByGlobalNorm):
        total = sum((g.float() ** 2).sum() for g in grads)
        gn = torch.sqrt(total)
        scale = grad_clip.clip_norm / torch.clamp(gn, min=grad_clip.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]
    if isinstance(grad_clip, ClipGradByNorm):
        def per(g):
            n = torch.sqrt((g.float() ** 2).sum())
            s = torch.clamp(grad_clip.clip_norm / torch.clamp(n, min=1e-12),
                            max=1.0)
            return (g.float() * s).to(g.dtype)
        return [per(g) for g in grads]
    if isinstance(grad_clip, ClipGradByValue):
        return [g.clamp(grad_clip.min, grad_clip.max) for g in grads]
    return grads


def _to_device(batch, device):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.as_tensor(np.asarray(batch), device=device)


def _leaves(batch):
    if isinstance(batch, (tuple, list)):
        return [x for b in batch for x in _leaves(b)]
    if isinstance(batch, dict):
        return [x for b in batch.values() for x in _leaves(b)]
    return [batch]


class SpmdTrainer:
    """Hybrid-parallel training loop.

    - params and optimizer state live on the mesh's device, each marked
      with the reference's placements
    - the batch's leaves carry `batch_spec` (dp on the leading dim)
    - sharding_stage (ZeRO over the 'sharding' mesh axis, reference
      DygraphShardingOptimizer:53 / group_sharded_stage3.py:85):
        1 = optimizer states partitioned
        2 = + gradients partitioned
        3 = + parameters partitioned
      The placements change; the values and the arithmetic do not.
    """

    def __init__(self, model, optimizer, mesh: ProcessMesh, rules=None,
                 loss_fn=None, batch_spec=None, remat: bool = False,
                 dtype=None, sharding_stage: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.rules = rules or DP_ONLY_RULES
        self.sharding_stage = int(sharding_stage)
        if (self.sharding_stage and "sharding" in mesh.dim_names
                and mesh.get_dim_size("sharding") > 1):
            self._zero_axis = "sharding"
        else:
            self._zero_axis = None
        state = model.state_dict(keep_vars=True)
        if dtype is not None:
            from ..framework.dtypes import convert_dtype
            dt = convert_dtype(dtype)
            for t in state.values():
                if t.is_floating_point():
                    t.data = t.data.to(dt)
        self.param_names = list(state.keys())
        self.params = shard_params_by_rules(state, mesh, self.rules)
        self._zero_specs = {}
        for name, a in self.params.items():
            base = a.partition_spec
            self._zero_specs[name] = (
                _with_zero_axis(base, a.shape, mesh, self._zero_axis)
                if self._zero_axis is not None else base)
        if self._zero_axis is not None and self.sharding_stage >= 3:
            for name, a in self.params.items():
                _place(a, mesh, self._zero_specs[name])
        self._trained = [n for n, a in self.params.items()
                         if a.is_floating_point()]
        for n in self._trained:
            self.params[n].requires_grad_(True)
        # optimizer states shard like their params (ZeRO >= 1: partitioned)
        self.opt_state = {}
        for name, a in self.params.items():
            st = optimizer.init_state(a.detach())
            spec = self._zero_specs[name] if self._zero_axis is not None \
                else a.partition_spec
            self.opt_state[name] = {
                k: _place(v, mesh, spec if v.shape == a.shape else P())
                for k, v in st.items()}
        self.step_count = 0
        self._loss = make_loss_fn(model, loss_fn)
        if batch_spec is None:
            batch_spec = P("dp") if "dp" in mesh.dim_names else P(None)
        self.batch_spec = batch_spec
        self.remat = remat
        self._compiled = None

    def _build(self):
        loss_pure = self._loss
        if self.remat:
            inner = loss_pure

            def loss_pure(p, b, k):
                return checkpoint(inner, p, b, k, use_reentrant=False)
        grad_clip = getattr(self.optimizer, "_grad_clip", None)
        stage = self.sharding_stage if self._zero_axis is not None else 0
        names = self._trained

        def train_step(params, opt_state, batch, rng_key, step, lr):
            loss = loss_pure(params, batch, rng_key)
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
            grads = _clip(grad_clip, [
                torch.zeros_like(params[n]) if g is None else g
                for n, g in zip(names, grads)])
            grads = dict(zip(names, grads))
            if stage >= 2:
                # ZeRO-2: each process id keeps its slice of every gradient
                for n, g in grads.items():
                    _place(g, self.mesh, self._zero_specs[n])
            self.optimizer.tree_update(
                {n: params[n] for n in names}, grads,
                {n: opt_state[n] for n in names}, lr, step)
            return loss.detach()

        return train_step

    def step(self, batch, rng_key=None):
        """batch: (x, y) of tensors or arrays. Returns the loss as a
        device tensor (no host sync)."""
        batch = _to_device(batch, self.mesh.device)
        for leaf in _leaves(batch):
            if isinstance(leaf, torch.Tensor) and leaf.ndim:
                _place(leaf, self.mesh, self.batch_spec[:leaf.ndim])
        if self._compiled is None:
            self._compiled = self._build()
        if rng_key is None:
            rng_key = int(torch.randint(0, 2**62, (1,),
                                        generator=get_generator("cpu")))
        self.step_count += 1
        lr = float(self.optimizer.get_lr())
        return self._compiled(self.params, self.opt_state, batch, rng_key,
                              self.step_count, lr)

    @torch.no_grad()
    def sync_to_model(self):
        """Copy the trained tensors, and their marks, into the model's."""
        state = self.model.state_dict(keep_vars=True)
        for name, t in state.items():
            if name in self.params:
                src = self.params[name]
                if t.shape == src.shape and t.dtype == src.dtype and \
                        t.device == src.device:
                    t.copy_(src)
                else:
                    t.data = src.detach().clone()
                t.process_mesh = src.process_mesh
                t.placements = list(src.placements)
