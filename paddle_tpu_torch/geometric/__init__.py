"""Graph learning ops. reference: paddle_tpu/geometric/__init__.py
(`_out_size` :32, `_segment_reduce` :43, `send_u_recv` :60, `send_ue_recv`
:72, `send_uv` :88, the `segment_*` family, `sample_neighbors` :116,
`reindex_graph` :150, `weighted_sample_neighbors` :169,
`reindex_heter_graph` :218).

Message passing is a gather (x[src]) and a reduction onto dst: `index_add`
for sum and mean (mean divides by max(count, 1)), `scatter_reduce(...,
include_self=False)` for max and min, whose untouched rows stay 0 as the
reference's do. On CUDA the sums are atomic: their order, and so a float
result's last bits, varies between runs. Without `out_size` the row count
is dst.max() + 1, one host read.

Sampling and reindexing build ragged outputs on the host, vectorised with
numpy. The draws come from the port's CPU generator (`paddle.seed`), not
the reference's unseeded numpy state, so they match it in distribution
only: each picked id a true neighbour, min(deg, size) of them with no
repeats, all of them for sample_size -1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.random import get_generator

__all__ = [
    "weighted_sample_neighbors", "reindex_heter_graph", "send_u_recv",
    "send_ue_recv", "send_uv", "segment_sum", "segment_mean", "segment_max",
    "segment_min", "sample_neighbors", "reindex_graph"]

_COMBINE = {"add": torch.add, "sub": torch.subtract, "mul": torch.multiply,
            "div": torch.divide}


def _out_size(out_size, dst_index):
    if out_size is not None:
        return int(out_size)
    return int(dst_index.max()) + 1 if dst_index.numel() else 0


def _segment_reduce(msgs, dst, num, pool_type):
    """Reduce the rows of `msgs` onto `num` rows by `dst`."""
    dst = dst.long()
    shape = (num,) + tuple(msgs.shape[1:])
    if pool_type in ("sum", "mean"):
        s = msgs.new_zeros(shape).index_add(0, dst, msgs)
        if pool_type == "sum":
            return s
        cnt = msgs.new_zeros(num).index_add(0, dst, msgs.new_ones(len(dst)))
        return s / torch.clamp(cnt, min=1).reshape((num,) + (1,) * (
            msgs.dim() - 1))
    if pool_type not in ("max", "min"):
        raise ValueError(f"reduce op {pool_type!r}: sum, mean, max or min")
    index = dst.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    out = msgs.new_zeros(shape).scatter_reduce(
        0, index, msgs, "amax" if pool_type == "max" else "amin",
        include_self=False)
    # Paddle's rule: rows no message reached are 0, not +-inf
    touched = torch.bincount(dst, minlength=num) > 0
    return torch.where(touched.reshape((num,) + (1,) * (msgs.dim() - 1)),
                       out, torch.zeros((), dtype=out.dtype,
                                        device=out.device))


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather x[src] and reduce it onto dst."""
    num = _out_size(out_size, dst_index)
    return _segment_reduce(x[src_index.long()], dst_index, num,
                           reduce_op.lower())


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Combine x[src] with the edge features y, reduce onto dst."""
    num = _out_size(out_size, dst_index)
    msgs = _COMBINE[message_op.lower()](x[src_index.long()], y)
    return _segment_reduce(msgs, dst_index, num, reduce_op.lower())


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """An edge's message from both of its ends: x[src] op y[dst]."""
    return _COMBINE[message_op.lower()](x[src_index.long()],
                                        y[dst_index.long()])


def _segment(pool):
    def op(data, segment_ids, name=None):
        num = int(segment_ids.max()) + 1 if segment_ids.numel() else 0
        return _segment_reduce(data, segment_ids, num, pool)
    op.__name__ = f"segment_{pool}"
    op.__doc__ = (f"The {pool} of `data`'s rows by segment id (rows no id "
                  "names are 0).")
    return op


segment_sum = _segment("sum")
segment_mean = _segment("mean")
segment_max = _segment("max")
segment_min = _segment("min")


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _device(*tensors):
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _uniforms(n):
    """n uniforms in [0, 1) from the port's CPU generator, as float64."""
    return torch.rand(n, generator=get_generator("cpu"),
                      dtype=torch.float64).numpy()


def _segments(colptr, nodes):
    """(lo, deg, seg, pos): each node's first edge and degree, and for
    every candidate edge its node's index and its position in the CSC
    arrays."""
    lo = colptr[nodes].astype(np.int64)
    deg = colptr[nodes + 1].astype(np.int64) - lo
    seg = np.repeat(np.arange(len(nodes)), deg)
    starts = np.cumsum(deg) - deg
    pos = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(
        starts, deg) + np.repeat(lo, deg)
    return deg, seg, pos, starts


def _pick(keys, deg, seg, starts, take):
    """The positions (into the candidate list) of the `take[i]` smallest
    keys of each node's segment, in key order."""
    order = np.lexsort((keys, seg))
    rank = np.arange(len(seg)) - np.repeat(starts, deg)
    return order[rank < np.repeat(take, deg)]


def _uniform_sample(colptr, nodes, sample_size):
    """Uniform sampling without replacement: random keys in each segment
    of more than `sample_size` edges, in-order keys (all taken) in the
    rest. Returns (picked CSC positions, counts)."""
    deg, seg, pos, starts = _segments(colptr, nodes)
    take = deg if sample_size < 0 else np.minimum(deg, sample_size)
    full = (take == deg)[seg]
    keys = np.where(full, pos.astype(np.float64), _uniforms(len(pos)))
    return pos[_pick(keys, deg, seg, starts, take)], take


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbour sampling on a CSC graph (`row` the source of each
    edge, `colptr` each node's first edge): (neighbors, counts int32[,
    eids]) on `row`'s device; a node of degree <= sample_size (or
    sample_size -1) keeps all its neighbours in edge order."""
    row_np, cp = _host(row), _host(colptr)
    nodes = _host(input_nodes).astype(np.int64)
    picked, take = _uniform_sample(cp, nodes, sample_size)
    dev = _device(row)
    neighbors = torch.as_tensor(row_np[picked], device=dev)
    counts = torch.as_tensor(take.astype(np.int32), device=dev)
    if return_eids:
        if eids is None:
            raise ValueError("return_eids=True requires eids")
        return neighbors, counts, torch.as_tensor(_host(eids)[picked],
                                                  device=dev)
    return neighbors, counts


def _first_seen(*arrays):
    """(unique values in order of first appearance across `arrays`, the
    local id of every element of each array)."""
    allv = np.concatenate([np.asarray(a).reshape(-1) for a in arrays])
    uniq, first, inv = np.unique(allv, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    local = np.empty(len(uniq), np.int64)
    local[order] = np.arange(len(uniq))
    ids = local[inv]
    out, at = [], 0
    for a in arrays:
        n = np.asarray(a).size
        out.append(ids[at:at + n])
        at += n
    return uniq[order], out


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Global node ids to local ones: the input nodes x first, then each
    new neighbour in order of appearance. Returns (reindexed neighbours,
    the edges' dst (x's position repeated by count), the nodes)."""
    x_np, nbr_np, cnt_np = _host(x), _host(neighbors), _host(count)
    nodes, (_, local) = _first_seen(x_np, nbr_np)
    dst = np.repeat(np.arange(len(x_np)), cnt_np)
    dev = _device(x, neighbors)
    return (torch.as_tensor(local.astype(nbr_np.dtype), device=dev),
            torch.as_tensor(dst.astype(nbr_np.dtype), device=dev),
            torch.as_tensor(nodes.astype(x_np.dtype), device=dev))


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    """Neighbour sampling with probability proportional to the edge
    weight, without replacement (Efraimidis-Spirakis keys -log(u) / w, the
    distribution of numpy's sequential weighted choice). Zero-weight edges
    fill a segment with fewer positive edges than sample_size uniformly.
    Returns int64 (neighbors, counts[, eids])."""
    r, cp = _host(row), _host(colptr)
    wts = _host(edge_weight).astype(np.float64)
    nodes = _host(input_nodes).astype(np.int64)
    if return_eids and eids is None:
        raise ValueError("return_eids=True requires eids")
    deg, seg, pos, starts = _segments(cp, nodes)
    take = deg if sample_size <= 0 else np.minimum(deg, sample_size)
    w = wts[pos]
    with np.errstate(divide="ignore"):
        keys = np.where(w > 0, -np.log1p(-_uniforms(len(pos))) / np.where(
            w > 0, w, 1.0), np.inf)
    full = (take == deg)[seg]
    keys = np.where(full, pos.astype(np.float64), keys)
    # zero-weight edges (key inf) come last, in a uniform order
    order = np.lexsort((_uniforms(len(pos)), keys, seg))
    rank = np.arange(len(seg)) - np.repeat(starts, deg)
    picked = pos[order[rank < np.repeat(take, deg)]]
    dev = _device(row)
    res = (torch.as_tensor(r[picked].astype(np.int64), device=dev),
           torch.as_tensor(take.astype(np.int64), device=dev))
    if return_eids:
        res += (torch.as_tensor(_host(eids)[picked].astype(np.int64),
                                device=dev),)
    return res


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """reindex_graph over several edge types: one mapping for all of them,
    x first, then each type's neighbours in turn."""
    xs = _host(x)
    nbs = [_host(nb) for nb in neighbors]
    cts = [_host(ct) for ct in count]
    nodes, locals_ = _first_seen(xs, *nbs)
    srcs = np.concatenate([loc.astype(np.int64) for loc in locals_[1:]])
    dsts = np.concatenate([np.repeat(np.arange(len(xs), dtype=np.int64), ct)
                           for ct in cts])
    dev = _device(x)
    return (torch.as_tensor(srcs, device=dev),
            torch.as_tensor(dsts, device=dev),
            torch.as_tensor(nodes.astype(np.int64), device=dev))
