"""The sparse embedding over a PS table. reference:
paddle_tpu/distributed/ps/embedding.py (`_PsLookup` :48, `PsEmbedding`
:74, `ps_sparse_embedding` :97, `PsBatch` :106), after the PS-mode
sparse_embedding (python/paddle/static/nn/common.py).

Two paths:

1. Eager (`PsEmbedding`): the batch's unique ids are pulled once, the rows
   gathered on the ids' device; the backward (a torch.autograd.Function)
   sums the rows' cotangents by unique id on the host and pushes them, so
   each row crosses between host and device once a batch however often it
   repeats.
2. A fixed-shape step (`PsBatch`): prepare(ids) pulls the unique rows into
   a buffer padded to a static capacity, the step gathers `rows[inv]` and
   returns the cotangent of `rows`, and complete(drows) pushes the live
   rows' part. Padding rows are zero and their gradients are dropped. A
   fixed capacity keeps the step's shapes (and a captured CUDA graph)
   the same from batch to batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ...nn import Layer

__all__ = ["PsEmbedding", "ps_sparse_embedding", "PsBatch"]


def _pull_unique(source, table_id, uniq):
    if hasattr(source, "pull_unique"):
        return source.pull_unique(table_id, uniq)
    return source.pull(uniq)  # GeoWorkerCache binds its table_id


def _push_unique(source, table_id, uniq, agg):
    if hasattr(source, "push_unique"):
        source.push_unique(table_id, uniq, agg)
    else:
        source.push(uniq, agg)


def _ids_numpy(ids):
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy()
    return np.asarray(ids)


class _PsLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, ids, source, table_id, emb_dim):
        ids_np = _ids_numpy(ids)
        uniq, inv = np.unique(ids_np.reshape(-1).astype(np.uint64),
                              return_inverse=True)
        rows = torch.from_numpy(_pull_unique(source, table_id, uniq))
        device = ids.device if isinstance(ids, torch.Tensor) else \
            anchor.device
        inv_t = torch.from_numpy(inv.reshape(-1).astype(np.int64))
        out = rows.to(device)[inv_t.to(device)].reshape(
            ids_np.shape + (emb_dim,))
        ctx.ps_state = (source, table_id, uniq, inv.reshape(-1), emb_dim)
        ctx.anchor_like = (anchor.dtype, anchor.device)
        # anchor (a trainable zero) keeps the node on the tape: integer ids
        # carry no gradient, and without it autograd would prune the
        # backward that pushes
        return out + anchor.to(out.dtype)

    @staticmethod
    def backward(ctx, grad):
        source, table_id, uniq, inv, emb_dim = ctx.ps_state
        g = grad.detach().float().cpu().numpy().reshape(-1, emb_dim)
        agg = np.zeros((uniq.size, emb_dim), np.float32)
        np.add.at(agg, inv, g)
        _push_unique(source, table_id, uniq, agg)
        dtype, device = ctx.anchor_like
        return (torch.zeros(1, dtype=dtype, device=device), None, None,
                None, None)


class PsEmbedding(Layer):
    """An embedding whose rows live in a PS client or geo cache: forward
    pulls the batch's unique rows and gathers them on the ids' device;
    backward pushes the rows' summed gradients (the server applies the
    table's rule)."""

    def __init__(self, embedding_dim, source, table_id=0, name=None, *,
                 device=None):
        super().__init__()
        self.emb_dim = int(embedding_dim)
        self.source = source
        self.table_id = int(table_id)
        # see _PsLookup.forward: the tape's anchor, always zero
        self.anchor = torch.nn.Parameter(torch.zeros(
            1, device=_device(device)))

    def forward(self, ids):
        return _PsLookup.apply(self.anchor, ids, self.source, self.table_id,
                               self.emb_dim)


def _device(device):
    from ...framework.device import resolve_device
    return resolve_device(device)


def ps_sparse_embedding(ids, source, emb_dim, table_id=0, anchor=None):
    """The functional PsEmbedding: the backward pushes only through an
    `anchor` that requires grad."""
    if anchor is None:
        device = ids.device if isinstance(ids, torch.Tensor) else "cpu"
        anchor = torch.zeros(1, device=device, requires_grad=True)
    return _PsLookup.apply(anchor, ids, source, table_id, emb_dim)


class PsBatch:
    """The static-shape pull/push bracket around a training step:

        batch = PsBatch(client, table_id, emb_dim, capacity=4096)
        rows, inv = batch.prepare(ids)          # host: pull + pad
        loss, drows = step(rows, inv, ...)      # device: rows[inv]
        batch.complete(drows)                   # host: push

    `drows` is the cotangent of `rows`, summed over each row's positions
    (autograd of rows[inv] gives it). `device` is where prepare puts rows
    and inv (the port's default device if None)."""

    def __init__(self, source, table_id, emb_dim, capacity, *, device=None):
        self.source = source
        self.table_id = int(table_id)
        self.emb_dim = int(emb_dim)
        self.capacity = int(capacity)
        self.device = _device(device)
        self._uniq = None

    def prepare(self, ids):
        """(rows (capacity, emb_dim) float32, inv (ids.size,) int64) on the
        batch's device; raises ValueError past the capacity."""
        ids_np = _ids_numpy(ids).reshape(-1)
        uniq, inv = np.unique(ids_np.astype(np.uint64), return_inverse=True)
        if uniq.size > self.capacity:
            raise ValueError(
                f"batch has {uniq.size} unique ids > PsBatch capacity "
                f"{self.capacity}; raise capacity")
        rows = _pull_unique(self.source, self.table_id, uniq)
        padded = np.zeros((self.capacity, self.emb_dim), np.float32)
        padded[:uniq.size] = rows
        self._uniq = uniq
        return (torch.from_numpy(padded).to(self.device),
                torch.from_numpy(inv.reshape(-1).astype(np.int64)).to(
                    self.device))

    def complete(self, drows):
        """Push the live rows' part of drows (capacity, emb_dim)."""
        if self._uniq is None:
            raise RuntimeError("PsBatch.complete before prepare")
        uniq = self._uniq
        self._uniq = None
        if isinstance(drows, torch.Tensor):
            drows = drows.detach().float().cpu().numpy()
        g = np.asarray(drows, np.float32)[:uniq.size]
        _push_unique(self.source, self.table_id, uniq, g)
