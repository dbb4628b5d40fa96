"""Eager collectives. reference: paddle_tpu/distributed/collective.py
(after python/paddle/distributed/communication/).

- A world of one: each collective is the identity, as in the reference.
- A multi-process world (`init_parallel_env` under the launcher): the
  reference's semantics over `torch.distributed`. A reduction all-gathers
  the (world, ...) stack and reduces it in rank order (`_reduce_stacked`,
  as the reference does), so every rank gets the same bits whatever the
  backend's own reduction order; reduce_scatter keeps this rank's row of
  the reduced stack; scatter broadcasts the source's stack and keeps this
  rank's row; gather all-gathers and the destination keeps the list.
- Under gloo, which takes few collectives on CUDA tensors, every
  collective stages its tensors through the host explicitly (`_host`):
  the tensor is copied to the CPU, the collective runs there, and the
  result is copied back to the tensor's device. Under NCCL they run on the
  card.
- A group smaller than the world raises, as the reference's
  `_require_trivial_world` does; so do all_to_all and all_gather_object
  over more than one rank.
- send/recv/batch_isend_irecv go over the TCPStore with the reference's
  key scheme (`__p2p/<src>-><dst>/<seq>`, a 4-byte big-endian header
  length, a JSON header of dtype and shape, the raw bytes).
- `split` raises, as the reference's does: its tensor-parallel layers are
  fleet.meta_parallel's.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as tdist

from . import parallel_env
from .parallel_env import Group, get_world_size, new_group  # noqa: F401

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_object",
           "all_to_all", "all_to_all_single", "reduce_scatter", "broadcast",
           "reduce", "scatter", "gather", "send", "recv", "isend", "irecv",
           "P2POp", "batch_isend_irecv", "split", "stream"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class _Task:
    def wait(self):
        return True

    def is_completed(self):
        return True


def _is_multiprocess_world(group):
    """A process group of more than one rank that `group` spans."""
    n = get_world_size()
    if n <= 1:
        return False
    return group is None or set(group.ranks) == set(range(n))


def _require_trivial_world(group, name):
    """Outside a whole multi-process world, an eager collective is right
    only over one rank: returning the input for a bigger group would
    compute wrong numbers, so it raises."""
    n = group.nranks if group is not None else get_world_size()
    if n > 1:
        raise RuntimeError(
            f"{name} over {n} ranks is not supported eagerly, as in the "
            "reference: a group smaller than the world, and all_to_all or "
            "all_gather_object over more than one rank, need a mesh "
            "(ROADMAP Queue 1 item 2)")


def _reduce_stacked(g, op):
    """Reduce a (world, ...) stack over its first axis by ReduceOp, in rank
    order, in the stack's dtype (a mean of integers in float32, as
    jnp.mean gives)."""
    if op == ReduceOp.SUM:
        return g.sum(0, dtype=g.dtype)
    if op == ReduceOp.MAX:
        return g.amax(0)
    if op == ReduceOp.MIN:
        return g.amin(0)
    if op == ReduceOp.PROD:
        return g.prod(0, dtype=g.dtype)
    if op == ReduceOp.AVG:
        return (g if g.is_floating_point() else g.float()).mean(0)
    raise ValueError(op)


def _host(t):
    """The tensor the backend takes: a host copy under gloo."""
    t = t.detach()
    if parallel_env.get_backend() == "gloo" and t.device.type != "cpu":
        return t.cpu()
    return t.contiguous()


def _write(dst, src):
    """dst holding src's values (on dst's device), in place where shapes
    allow, rebound otherwise."""
    from ..tensor import _write as write
    return write(dst, src.to(dst.device))


def _all_gather_stack(t):
    """(world, *t.shape): rank r's tensor at [r], on t's device."""
    x = _host(t)
    parts = [torch.empty_like(x) for _ in range(get_world_size())]
    tdist.all_gather(parts, x)
    return torch.stack(parts).to(t.device)


def _broadcast_from(t, src):
    x = _host(t).clone()
    tdist.broadcast(x, src)
    return x.to(t.device)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    if _is_multiprocess_world(group):
        with torch.no_grad():
            _write(tensor, _reduce_stacked(_all_gather_stack(tensor), op))
        return _Task()
    _require_trivial_world(group, "all_reduce")
    return _Task()  # a world of one: the reduction is the identity


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    if _is_multiprocess_world(group):
        tensor_list.extend(_all_gather_stack(tensor).unbind(0))
        return _Task()
    _require_trivial_world(group, "all_gather")
    tensor_list.append(tensor)
    return _Task()


def all_gather_object(object_list, obj, group=None):
    _require_trivial_world(group, "all_gather_object")
    object_list.append(obj)
    return _Task()


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    _require_trivial_world(group, "all_to_all")
    out_tensor_list.extend(in_tensor_list)
    return _Task()


def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None,
                      in_split_sizes=None, group=None, sync_op=True):
    _require_trivial_world(group, "all_to_all_single")
    with torch.no_grad():
        _write(out_tensor, in_tensor.clone())
    return _Task()


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    if _is_multiprocess_world(group):
        stack = torch.stack([t.to(tensor.device) for t in tensor_list])
        red = _reduce_stacked(_all_gather_stack(stack), op)   # (world, ...)
        with torch.no_grad():
            _write(tensor, red[parallel_env.get_rank()])
        return _Task()
    _require_trivial_world(group, "reduce_scatter")
    with torch.no_grad():
        _write(tensor, tensor_list[0])
    return _Task()


def broadcast(tensor, src=0, group=None, sync_op=True):
    if _is_multiprocess_world(group):
        with torch.no_grad():
            _write(tensor, _broadcast_from(tensor, src))
        return _Task()
    _require_trivial_world(group, "broadcast")
    return _Task()


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As the reference: every rank gets the reduction."""
    return all_reduce(tensor, op, group, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    if _is_multiprocess_world(group):
        me = parallel_env.get_rank()
        if me == src:
            if not tensor_list:
                raise ValueError("scatter: src rank needs tensor_list")
            stack = torch.stack([t.to(tensor.device) for t in tensor_list])
        else:   # every rank sends the same shape: zeros off the source
            stack = torch.zeros((get_world_size(),) + tuple(tensor.shape),
                                dtype=tensor.dtype, device=tensor.device)
        with torch.no_grad():
            _write(tensor, _broadcast_from(stack, src)[me])
        return _Task()
    _require_trivial_world(group, "scatter")
    if tensor_list:
        with torch.no_grad():
            _write(tensor, tensor_list[0])
    return _Task()


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    if _is_multiprocess_world(group):
        g = _all_gather_stack(tensor)
        if gather_list is not None and parallel_env.get_rank() == dst:
            gather_list.extend(g.unbind(0))
        return _Task()
    _require_trivial_world(group, "gather")
    if gather_list is not None:
        gather_list.append(tensor)
    return _Task()


#: per-(src, dst) sequence counters of the store's p2p: both ends count
#: their own calls, so a matching send and recv agree on the key
_P2P_SEQ: dict = {}


def _p2p_store(what):
    if get_world_size() <= 1:
        raise NotImplementedError(
            f"eager {what} is cross-process only (a world of one has no "
            "peer)")
    store = parallel_env.get_store()
    if store is None:
        raise RuntimeError(
            f"eager {what} needs the multi-process TCPStore "
            "(init_parallel_env with a PADDLE_MASTER rendezvous)")
    return store


def _next_key(src, dst):
    seq = _P2P_SEQ.get((src, dst), 0)
    _P2P_SEQ[(src, dst)] = seq + 1
    return f"__p2p/{src}->{dst}/{seq}"


_NUMPY_LESS = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def send(tensor, dst=0, group=None, sync_op=True):
    """Post `tensor` to rank `dst` through the store."""
    store = _p2p_store("send/recv")
    t = tensor.detach().contiguous().cpu()
    name = str(t.dtype).removeprefix("torch.")
    raw = (t.view(torch.uint8) if t.dtype in _NUMPY_LESS else t).numpy()
    dtype = name if t.dtype in _NUMPY_LESS else str(raw.dtype)
    header = json.dumps({"dtype": dtype, "shape": list(t.shape)}).encode()
    store.set(_next_key(parallel_env.get_rank(), dst),
              len(header).to_bytes(4, "big") + header + raw.tobytes())
    return _Task()


def recv(tensor, src=0, group=None, sync_op=True):
    """Take the next tensor rank `src` posted, into `tensor`."""
    from ..convert import tensor_from_bytes
    store = _p2p_store("send/recv")
    key = _next_key(src, parallel_env.get_rank())
    store.wait(key)
    raw = store.get(key)
    hlen = int.from_bytes(raw[:4], "big")
    header = json.loads(raw[4:4 + hlen].decode())
    body = np.frombuffer(raw[4 + hlen:], dtype=np.uint8)
    if header["dtype"] in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        got = tensor_from_bytes(body, header["dtype"], header["shape"])
    else:
        got = torch.from_numpy(body.view(np.dtype(header["dtype"])).reshape(
            header["shape"]).copy())
    with torch.no_grad():
        _write(tensor, got)
    store.delete_key(key)   # a one-shot mailbox: the store does not grow
    return _Task()


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group)


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Every send of the batch is posted before any recv, so symmetric
    exchanges cannot deadlock (a store send does not block)."""
    _p2p_store("batched p2p")
    sends = [p for p in p2p_op_list if p.op in (send, isend)]
    recvs = [p for p in p2p_op_list if p.op in (recv, irecv)]
    if len(sends) + len(recvs) != len(p2p_op_list):
        raise ValueError("P2POp.op must be send/isend/recv/irecv")
    return ([send(p.tensor, p.peer, p.group) for p in sends]
            + [recv(p.tensor, p.peer, p.group) for p in recvs])


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          inner_rank=-1):
    raise NotImplementedError("use fleet.meta_parallel TP layers")


# paddle.distributed.stream is communication.stream (the one-tensor
# forms); imported last, since stream imports this module
from .communication import stream  # noqa: E402,F401
