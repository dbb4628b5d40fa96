"""paddle.incubate. reference: paddle_tpu/incubate/__init__.py: `autograd`,
`nn`, `asp`, `autotune`, `distributed` (the MoE layer), the segment ops
(:22-58), `graph_send_recv` (:59), `graph_reindex`,
`graph_sample_neighbors`, `graph_khop_sampler` (:219), `identity_loss`
(:112), `softmax_mask_fuse` (:122), `softmax_mask_fuse_upper_triangle`
(:130), `LookAhead` (:141) and `ModelAverage` (:181).

Unlike geometric's segment ops, these leave a segment no id names at the
reduction's identity, as jax.ops' do: 0 for the sum and the mean, the
dtype's lowest value for the max (-inf for floats) and its highest for
the min. The graph samplers draw on the host from the port's CPU
generator (geometric's vectorised sampler): the reference's numpy draws
are matched in distribution, not in bits.
"""

import contextlib

import numpy as np
import torch

from . import asp, autograd, autotune, distributed, nn  # noqa: F401
from .. import inference  # noqa: F401
from ..geometric import (_device, _first_seen, _host, _uniform_sample,
                         send_u_recv)
from ..optimizer import LBFGS  # noqa: F401

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "graph_send_recv", "graph_reindex", "graph_sample_neighbors",
           "graph_khop_sampler", "identity_loss", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "LookAhead", "ModelAverage",
           "LBFGS"]


def _num(segment_ids):
    return int(segment_ids.max()) + 1


def _reduce_into(data, segment_ids, how, fill):
    n = _num(segment_ids)
    out = torch.full((n,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                     device=data.device)
    index = segment_ids.long().reshape(
        (-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, how, include_self=False)


def segment_sum(data, segment_ids, name=None):
    n = _num(segment_ids)
    return data.new_zeros((n,) + tuple(data.shape[1:])).index_add(
        0, segment_ids.long(), data)


def segment_mean(data, segment_ids, name=None):
    tot = segment_sum(data, segment_ids)
    cnt = segment_sum(torch.ones_like(data), segment_ids)
    return tot / torch.clamp(cnt, min=1.0)


def _lowest(dtype):
    return -float("inf") if dtype.is_floating_point else \
        torch.iinfo(dtype).min


def _highest(dtype):
    return float("inf") if dtype.is_floating_point else \
        torch.iinfo(dtype).max


def segment_max(data, segment_ids, name=None):
    return _reduce_into(data, segment_ids, "amax", _lowest(data.dtype))


def segment_min(data, segment_ids, name=None):
    return _reduce_into(data, segment_ids, "amin", _highest(data.dtype))


def graph_send_recv(x, src_index, dst_index, pool_type="sum", out_size=None,
                    name=None):
    """geometric.send_u_recv under its older name."""
    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    """(reindexed neighbours, dst, nodes), int64: x's ids first, then the
    new neighbours in order of appearance."""
    xs, nb, cnt = _host(x), _host(neighbors), _host(count)
    nodes, (_, local) = _first_seen(xs, nb)
    dst = np.repeat(np.arange(len(xs), dtype=np.int64), cnt)
    dev = _device(x)
    return (torch.as_tensor(local.astype(np.int64), device=dev),
            torch.as_tensor(dst, device=dev),
            torch.as_tensor(nodes.astype(np.int64), device=dev))


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    """(neighbours, counts), int64: up to sample_size neighbours of each
    node without repeats (all of them for -1). As in the reference, no
    eids are returned."""
    r, cp = _host(row), _host(colptr)
    nodes = _host(input_nodes).astype(np.int64)
    picked, take = _uniform_sample(cp, nodes, sample_size)
    dev = _device(row)
    return (torch.as_tensor(r[picked].astype(np.int64), device=dev),
            torch.as_tensor(take.astype(np.int64), device=dev))


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """K-hop sampling: graph_sample_neighbors hop by hop from the sorted
    unique frontier, then one reindexing of every edge. Returns (src,
    dst, nodes, [edge count]), int64."""
    cur = _host(input_nodes)
    srcs, dsts = [], []
    frontier = cur
    for k in sample_sizes:
        nbrs, cnts = graph_sample_neighbors(row, colptr, frontier,
                                            sample_size=int(k))
        nb = _host(nbrs)
        srcs.append(nb)
        dsts.append(np.repeat(frontier, _host(cnts)))
        frontier = np.unique(nb)
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    nodes, (_, re_src, re_dst) = _first_seen(cur, src, dst)
    dev = _device(row)
    return (torch.as_tensor(re_src.astype(np.int64), device=dev),
            torch.as_tensor(re_dst.astype(np.int64), device=dev),
            torch.as_tensor(nodes.astype(np.int64), device=dev),
            torch.as_tensor([len(re_src)], dtype=torch.int64, device=dev))


def identity_loss(x, reduction="none"):
    """x summed (0, "sum"), averaged (1, "mean") or as it is."""
    if reduction in (0, "sum"):
        return x.sum()
    if reduction in (1, "mean"):
        return x.mean()
    return x


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis."""
    return torch.softmax(x + mask.to(x.dtype), -1)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """The causal softmax: entries above the diagonal filled with -1e30
    in float32 (a half input is promoted to float32, as the reference's
    float32 fill promotes it)."""
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    a = x.to(torch.promote_types(x.dtype, torch.float32))
    return torch.softmax(torch.where(keep, a, torch.tensor(
        -1e30, dtype=a.dtype, device=a.device)), -1)


class LookAhead:
    """Lookahead: k steps of the inner optimizer (the fast weights), then
    the slow weights move alpha of the way to them and the fast weights
    restart from there. The slow weights start at the parameters' values
    when the wrapper is made."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step_count = 0
        self._slow = {id(p): p.detach().clone()
                      for p in inner_optimizer._parameter_list}

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k:
            return
        for p in self.inner_optimizer._parameter_list:
            slow = self._slow.setdefault(id(p), p.detach().clone())
            slow.add_(self.alpha * (p - slow))
            p.copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """The average of the parameters over the steps so far: `step()` adds
    them up, `apply()` swaps the averages in (a context manager that
    restores the parameters on exit unless need_restore is False),
    `restore()` swaps them back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._params = list(parameters or [])
        self._sum = {id(p): torch.zeros_like(p, requires_grad=False)
                     for p in self._params}
        self._cnt = 0
        self._backup = {}

    @torch.no_grad()
    def step(self):
        self._cnt += 1
        for p in self._params:
            self._sum[id(p)].add_(p)

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def ctx():
            with torch.no_grad():
                for p in self._params:
                    self._backup[id(p)] = p.detach().clone()
                    p.copy_(self._sum[id(p)] / max(self._cnt, 1))
            try:
                yield
            finally:
                if need_restore:
                    self.restore()
        return ctx()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))
