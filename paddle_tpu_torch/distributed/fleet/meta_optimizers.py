"""Hybrid-parallel and sharding optimizers. reference:
paddle_tpu/distributed/fleet/meta_optimizers.py (after fleet/
meta_optimizers/dygraph_optimizer/: HybridParallelOptimizer:266,
DygraphShardingOptimizer:53).

ZeRO as placements: after each step the optimizer's state tensors are
marked sharded on their leading dim over the 'sharding' axis of the hybrid
group's mesh (or 'dp' without a sharding axis), where it divides. The
in-step partition of every stage is parallel.SpmdTrainer's.
"""

from __future__ import annotations

import torch

from ..placement import Replicate, Shard, chunk_map

__all__ = ["HybridParallelOptimizer", "DygraphShardingOptimizer",
           "ShardingOptimizerStage1"]


class HybridParallelOptimizer:
    """reference: hybrid_parallel_optimizer.py:266 — wraps the inner
    optimizer; its clip sees the global gradients, so the cross-group norm
    reduction is implicit."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    def minimize(self, loss, **kw):
        return self._inner_opt.minimize(loss)


def _shard_axis_placements(hcg, t):
    """Shard(0) over the sharding (else dp) axis where it divides, or
    None."""
    mesh = hcg.mesh
    axis = "sharding" if hcg.get_sharding_parallel_world_size() > 1 \
        else "dp"
    if axis not in mesh.dim_names or t.ndim == 0:
        return None
    placements = [Shard(0) if n == axis else Replicate()
                  for n in mesh.dim_names]
    try:
        chunk_map(mesh, placements, t.shape)
    except ValueError:
        return None
    return placements


class DygraphShardingOptimizer:
    """ZeRO-1 (with the stage knob). reference:
    dygraph_sharding_optimizer.py:53."""

    def __init__(self, optimizer, hcg=None, stage=1):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._stage = stage

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        """The inner step, then each state tensor marked sharded over the
        sharding axis (left replicated where its leading dim does not
        divide)."""
        self._inner_opt.step()
        hcg = self._hcg
        if hcg is None:
            from . import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
        if hcg is None:
            return
        for st in self._inner_opt._accumulators.values():
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    placements = _shard_axis_placements(hcg, v)
                    if placements is not None:
                        v.process_mesh = hcg.mesh
                        v.placements = placements

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class ShardingOptimizerStage1(DygraphShardingOptimizer):
    def __init__(self, optimizer, stage=1, group=None):
        super().__init__(optimizer, None, stage)
