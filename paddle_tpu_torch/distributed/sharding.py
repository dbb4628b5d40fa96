"""Group sharded (ZeRO) entry points. reference:
paddle_tpu/distributed/sharding.py (after python/paddle/distributed/
sharding/group_sharded.py).

Stage N is a placement of the optimizer state (and at stages 2-3 of the
gradients and parameters) over the 'sharding' mesh axis;
parallel.SpmdTrainer(sharding_stage=1/2/3) lays out all three in its step.
This facade keeps the reference's one-call eager API on
fleet.meta_optimizers.ShardingOptimizerStage1.
"""

from __future__ import annotations

import os

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """(model, sharded optimizer, scaler); level "os", "os_g" or "p_g_os"
    is stage 1, 2 or 3."""
    from .fleet.meta_optimizers import ShardingOptimizerStage1
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}.get(level, 1)
    return model, ShardingOptimizerStage1(optimizer, stage=stage,
                                          group=group), scaler


def save_group_sharded_model(model, output, optimizer=None):
    from ..framework.io_file import save
    os.makedirs(output, exist_ok=True)
    save(model.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
