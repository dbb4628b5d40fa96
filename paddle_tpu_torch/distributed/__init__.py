"""paddle.distributed: the process layer. reference: paddle_tpu/
distributed/__init__.py.

Ported: the store (`store.py`), the parallel environment
(`parallel_env.py`), the eager collectives and their stream forms
(`collective.py`, `communication/`), the launcher (`launch/`), and
`alltoall`/`alltoall_single` in the reference's (in, out) argument order.
What needs a mesh or DTensor (placement, api, auto_parallel, fleet,
checkpoint, sharding, rpc, ps, watchdog, DataParallel) is ROADMAP Queue 1
item 2; tests/test_torch_distributed.py holds the names still missing to
the list there.
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

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "get_group",
           "new_group", "is_initialized", "ParallelEnv", "barrier",
           "destroy_process_group", "get_backend", "get_store",
           "all_reduce", "all_gather", "all_gather_object", "all_to_all",
           "all_to_all_single", "reduce_scatter", "broadcast", "reduce",
           "scatter", "gather", "send", "recv", "isend", "irecv", "ReduceOp",
           "P2POp", "batch_isend_irecv", "split", "stream", "communication",
           "Store", "TCPStore", "ResilientStore", "launch", "spawn",
           "alltoall", "alltoall_single"]


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
