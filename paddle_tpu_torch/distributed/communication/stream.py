"""paddle.distributed.communication.stream. reference: paddle_tpu/
distributed/communication/stream.py (after python/paddle/distributed/
communication/stream/, 11 entry points).

Each form runs the eager collective of collective.py and returns its
(completed) task: the port's eager collectives finish before they
return, so there is no stream to choose, and `use_calc_stream` orders
nothing; as in the reference it may be true only for a sync op. The
single-tensor forms take one pre-sized tensor as nranks equal chunks
along dim 0 (`_as_chunks`).
"""

from __future__ import annotations

import torch

from .. import collective as _c

__all__ = ["all_gather", "all_reduce", "alltoall", "alltoall_single",
           "broadcast", "reduce", "reduce_scatter", "recv", "scatter",
           "send", "gather"]


def _streamed(fn, *args, sync_op=True, use_calc_stream=False, **kwargs):
    if use_calc_stream and not sync_op:
        raise RuntimeError(
            "use_calc_stream can only be true in sync op behavior.")
    return fn(*args, sync_op=sync_op, **kwargs)


def _nranks(group):
    return group.nranks if group is not None else _c.get_world_size()


def _as_chunks(tensor, group, op_name):
    """One pre-sized tensor as nranks equal chunks along dim 0."""
    n = _nranks(group)
    if int(tensor.shape[0]) % n != 0:
        raise ValueError(
            f"{op_name}: tensor dim 0 ({int(tensor.shape[0])}) must be "
            f"divisible by the group world size ({n})")
    return list(torch.chunk(tensor, n, dim=0))


def _into(dst, parts):
    with torch.no_grad():
        _c._write(dst, torch.cat(parts, 0))


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _streamed(_c.all_reduce, tensor, op, group, sync_op=sync_op,
                     use_calc_stream=use_calc_stream)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    if isinstance(tensor_or_tensor_list, torch.Tensor):
        # one tensor of nranks * d0 rows
        out: list = []
        task = _streamed(_c.all_gather, out, tensor, group, sync_op=sync_op,
                         use_calc_stream=use_calc_stream)
        _into(tensor_or_tensor_list, out)
        return task
    return _streamed(_c.all_gather, tensor_or_tensor_list, tensor, group,
                     sync_op=sync_op, use_calc_stream=use_calc_stream)


def alltoall(out_tensor_or_tensor_list, in_tensor_or_tensor_list, group=None,
             sync_op=True, use_calc_stream=False):
    if isinstance(in_tensor_or_tensor_list, torch.Tensor) != \
            isinstance(out_tensor_or_tensor_list, torch.Tensor):
        raise ValueError(
            "alltoall: input and output must both be tensors or both "
            "be tensor lists")
    if isinstance(in_tensor_or_tensor_list, torch.Tensor):
        ins = _as_chunks(in_tensor_or_tensor_list, group, "alltoall")
        outs: list = []
        task = _streamed(_c.all_to_all, outs, ins, group, sync_op=sync_op,
                         use_calc_stream=use_calc_stream)
        _into(out_tensor_or_tensor_list, outs)
        return task
    return _streamed(_c.all_to_all, out_tensor_or_tensor_list,
                     in_tensor_or_tensor_list, group, sync_op=sync_op,
                     use_calc_stream=use_calc_stream)


def alltoall_single(out_tensor, in_tensor, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _streamed(_c.all_to_all_single, out_tensor, in_tensor,
                     out_split_sizes, in_split_sizes, group, sync_op=sync_op,
                     use_calc_stream=use_calc_stream)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _streamed(_c.broadcast, tensor, src, group, sync_op=sync_op,
                     use_calc_stream=use_calc_stream)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _streamed(_c.reduce, tensor, dst, op, group, sync_op=sync_op,
                     use_calc_stream=use_calc_stream)


def reduce_scatter(tensor, tensor_or_tensor_list, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    if isinstance(tensor_or_tensor_list, torch.Tensor):
        tensor_or_tensor_list = _as_chunks(tensor_or_tensor_list, group,
                                           "reduce_scatter")
    return _streamed(_c.reduce_scatter, tensor, tensor_or_tensor_list, op,
                     group, sync_op=sync_op, use_calc_stream=use_calc_stream)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    if isinstance(tensor_or_tensor_list, torch.Tensor):
        tensor_or_tensor_list = _as_chunks(tensor_or_tensor_list, group,
                                           "scatter")
    return _streamed(_c.scatter, tensor, tensor_or_tensor_list, src, group,
                     sync_op=sync_op, use_calc_stream=use_calc_stream)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True,
           use_calc_stream=False):
    return _streamed(_c.gather, tensor, gather_list, dst, group,
                     sync_op=sync_op, use_calc_stream=use_calc_stream)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _streamed(_c.send, tensor, dst, group, sync_op=sync_op,
                     use_calc_stream=use_calc_stream)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _streamed(_c.recv, tensor, src, group, sync_op=sync_op,
                     use_calc_stream=use_calc_stream)
