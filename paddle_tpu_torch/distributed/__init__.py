"""paddle.distributed. reference: paddle_tpu/distributed/__init__.py.

Ported: the store (`store.py`), the parallel environment
(`parallel_env.py`), the eager collectives and their stream forms
(`collective.py`, `communication/`), the launcher (`launch/`), and the mesh
layer: placements and ProcessMesh (`placement.py`), the DTensor API
(`api.py`), auto-parallel with its Engine (`auto_parallel.py`), the
auto-tuner, fleet with elastic membership, the distributed checkpoint,
`io`, group sharding and DataParallel, the step watchdog (`watchdog.py`),
and the parameter-server stack: `rpc`, `ps` and the slot datasets
(`dataset.py`). A DTensor holds its global value on one device and carries
its mesh and placements (placement.py). The public surface is the
reference's, with `ResilientStore` and `get_store` besides
(tests/test_torch_distributed.py).
"""

from __future__ import annotations

from . import communication  # noqa: F401
from .collective import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    all_to_all_single, batch_isend_irecv, broadcast, gather, irecv, isend,
    recv, reduce, reduce_scatter, scatter, send, split, stream)
from .launch import launch, spawn  # noqa: F401
from .parallel_env import (  # noqa: F401
    ParallelEnv, barrier, destroy_process_group, get_backend, get_group,
    get_rank, get_store, get_world_size, init_parallel_env, is_initialized,
    new_group)
from .store import ResilientStore, Store, TCPStore  # noqa: F401
from .placement import (  # noqa: F401
    Partial, Placement, ProcessMesh, Replicate, Shard)
from . import placement  # noqa: F401
from . import api  # noqa: F401
from .api import (  # noqa: F401
    dtensor_from_fn, dtensor_from_local, reshard, shard_dataloader,
    shard_layer, shard_optimizer, shard_tensor, to_distributed,
    unshard_dtensor)
from . import auto_parallel  # noqa: F401
from .auto_parallel import DistModel, Engine, Strategy, to_static  # noqa: F401
from . import auto_tuner  # noqa: F401
from .auto_tuner import AutoTuner, TunerConfig  # noqa: F401
from . import fleet  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from . import io  # noqa: F401
from . import sharding  # noqa: F401
from .sharding import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model)
from . import parallel  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from . import watchdog  # noqa: F401
from .watchdog import Watchdog, enable_comm_watchdog  # noqa: F401
from . import dataset  # noqa: F401
from .dataset import InMemoryDataset, QueueDataset  # noqa: F401
from . import ps  # noqa: F401
from .ps.accessor import (  # noqa: F401
    CountFilterEntry, ProbabilityEntry, ShowClickEntry)

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "get_group",
           "new_group", "is_initialized", "ParallelEnv", "barrier",
           "destroy_process_group", "get_backend", "get_store",
           "all_reduce", "all_gather", "all_gather_object", "all_to_all",
           "all_to_all_single", "reduce_scatter", "broadcast", "reduce",
           "scatter", "gather", "send", "recv", "isend", "irecv", "ReduceOp",
           "P2POp", "batch_isend_irecv", "split", "stream", "communication",
           "Store", "TCPStore", "ResilientStore", "launch", "spawn",
           "alltoall", "alltoall_single", "Placement", "Shard", "Replicate",
           "Partial", "ProcessMesh", "get_mesh", "set_mesh", "shard_tensor",
           "dtensor_from_fn", "dtensor_from_local", "reshard", "shard_layer",
           "shard_optimizer", "shard_dataloader", "shard_scaler",
           "unshard_dtensor", "to_distributed", "DistModel", "Engine",
           "Strategy", "to_static", "DistAttr", "ReduceType", "ParallelMode",
           "ShardingStage1", "ShardingStage2", "ShardingStage3",
           "AutoTuner", "TunerConfig", "fleet", "checkpoint",
           "save_state_dict", "load_state_dict", "io", "sharding",
           "group_sharded_parallel", "save_group_sharded_model",
           "DataParallel", "is_available", "wait", "broadcast_object_list",
           "scatter_object_list", "gloo_init_parallel_env", "gloo_barrier",
           "gloo_release", "watchdog", "Watchdog", "enable_comm_watchdog",
           "dataset", "InMemoryDataset", "QueueDataset", "ps",
           "CountFilterEntry", "ProbabilityEntry", "ShowClickEntry"]


def get_mesh():
    from .placement import _default_mesh
    return _default_mesh[0]


def set_mesh(mesh):
    from .placement import _default_mesh
    _default_mesh[0] = mesh


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """paddle.distributed.alltoall: the reference's (in, out) order, the
    reverse of all_to_all(out, in)."""
    return all_to_all(out_tensor_list, in_tensor_list, group=group,
                      sync_op=sync_op)


def alltoall_single(in_tensor, out_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """paddle.distributed.alltoall_single in the (in, out) order."""
    return all_to_all_single(out_tensor, in_tensor,
                             out_split_sizes=out_split_sizes,
                             in_split_sizes=in_split_sizes, group=group,
                             sync_op=sync_op)


class ReduceType:
    """reference: auto_parallel/placement_type ReduceType."""
    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4


class ParallelMode:
    """reference: fleet ParallelMode enum."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class _ShardingStage:
    stage = 0

    def __init__(self, *a, **k):
        pass


class ShardingStage1(_ShardingStage):
    """Marker for Strategy/shard_optimizer (reference auto_parallel api)."""
    stage = 1


class ShardingStage2(_ShardingStage):
    stage = 2


class ShardingStage3(_ShardingStage):
    stage = 3


class DistAttr:
    """The legacy mesh and sharding-spec pair (reference:
    distributed/auto_parallel/api.py:144); shard_tensor accepts it beside
    placements."""

    def __init__(self, mesh=None, sharding_specs=None):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs or [])

    def __repr__(self):
        return (f"DistAttr(mesh={self.process_mesh}, "
                f"sharding_specs={self.sharding_specs})")


def is_available():
    """torch.distributed's own availability."""
    import torch.distributed as tdist
    return tdist.is_available()


def wait(tensor, group=None, use_calc_stream=True):
    """A device sync: the collectives are ordered on the stream."""
    import torch
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    return tensor


def broadcast_object_list(object_list, src=0, group=None):
    """One controlling process: every process id already holds the
    objects (the reference's contract)."""
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """reference contract (communication/scatter.py:91): out_object_list's
    content is replaced by this rank's scattered object."""
    out_object_list[:] = [in_object_list[0]] if in_object_list else []
    return out_object_list


def shard_scaler(scaler):
    """reference: auto_parallel shard_scaler — the scaler's state is
    global already; returned unchanged."""
    return scaler


def gloo_init_parallel_env(*a, **k):
    raise NotImplementedError(
        "gloo_init_parallel_env is not a separate entry point: launch "
        "with --backend gloo and call init_parallel_env, as the reference "
        "has it raise")


def gloo_barrier(*a, **k):
    raise NotImplementedError("gloo_barrier: use barrier() after "
                              "init_parallel_env with the gloo backend")


def gloo_release(*a, **k):
    raise NotImplementedError("gloo_release: use destroy_process_group()")
