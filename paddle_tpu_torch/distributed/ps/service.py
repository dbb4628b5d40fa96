"""The PS service layer: sharded servers, the routing client and the
geo-async cache. reference: paddle_tpu/distributed/ps/service.py
(`owner_of` :33, `TableConfig` :41, `PsServer` :49, `serve_tables` :95,
`LocalChannel` :141, `RpcChannel` :166, `PsClient` :219, `GeoWorkerCache`
:305), after paddle/fluid/distributed/ps/service/.

Row ownership is a mixed hash of the feature id mod the number of servers,
computed vectorised on the client; each server holds one SparseTable shard
a logical table. A channel is either a direct in-process call
(LocalChannel) or the port's RPC (distributed/rpc: authenticated pickle
over TCP, the rendezvous on the port's TCPStore), whose server process
resolves the `_remote_*` functions by qualified name.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .accessor import CtrAccessor
from .table import DenseTable, SparseTable

__all__ = ["TableConfig", "PsServer", "PsClient", "LocalChannel",
           "RpcChannel", "GeoWorkerCache", "serve_tables"]

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def owner_of(ids: np.ndarray, num_servers: int) -> np.ndarray:
    """Row owner = mixed hash of the feature id, mod server count (stable
    across clients; uint64 wraparound is the mix)."""
    mixed = ids.astype(np.uint64) * _GOLDEN
    return ((mixed >> np.uint64(33)) % np.uint64(num_servers)).astype(
        np.int64)


class TableConfig:
    def __init__(self, table_id: int, emb_dim: int,
                 accessor: CtrAccessor | None = None):
        self.table_id = int(table_id)
        self.emb_dim = int(emb_dim)
        self.accessor = accessor or CtrAccessor()


class PsServer:
    """One PS shard: holds the local portion of every configured table."""

    def __init__(self, server_id: int, num_servers: int,
                 configs: list[TableConfig]):
        self.server_id = int(server_id)
        self.num_servers = int(num_servers)
        self.tables: dict[int, SparseTable] = {
            c.table_id: SparseTable(c.emb_dim, c.accessor) for c in configs}
        self.dense: dict[int, DenseTable] = {}

    # --- request handlers (bytes in/bytes out keeps RPC payloads flat) ----
    def pull(self, table_id: int, ids: np.ndarray) -> np.ndarray:
        return self.tables[table_id].pull(ids)

    def push(self, table_id: int, ids: np.ndarray,
             grads: np.ndarray) -> None:
        self.tables[table_id].push(ids, grads)

    def merge(self, table_id: int, ids: np.ndarray,
              deltas: np.ndarray) -> None:
        self.tables[table_id].merge(ids, deltas)

    def save(self, dirname: str) -> None:
        import os
        os.makedirs(dirname, exist_ok=True)
        for tid, t in self.tables.items():
            t.save(f"{dirname}/table{tid}.shard{self.server_id}")

    def load(self, dirname: str) -> None:
        for tid, t in self.tables.items():
            t.load(f"{dirname}/table{tid}.shard{self.server_id}")

    def stats(self) -> dict:
        return {tid: len(t) for tid, t in self.tables.items()}


# --------------------------------------------------------------------------
# module-global served instance: RPC calls resolve these by qualified name
# on the server process (pickle ships the function reference, not the code)
# --------------------------------------------------------------------------

_SERVED: dict[str, PsServer] = {}
_SERVED_LOCK = threading.Lock()


def serve_tables(server: PsServer, name: str = "default") -> None:
    with _SERVED_LOCK:
        _SERVED[name] = server


def _served(name: str) -> PsServer:
    s = _SERVED.get(name)
    if s is None:
        raise RuntimeError(f"no PS server '{name}' served in this process; "
                           "call ps.serve_tables() first")
    return s


def _remote_pull(name, table_id, ids_bytes, n):
    ids = np.frombuffer(ids_bytes, np.uint64, count=n)
    return _served(name).pull(table_id, ids).tobytes()


def _remote_push(name, table_id, ids_bytes, grads_bytes, n, dim):
    ids = np.frombuffer(ids_bytes, np.uint64, count=n)
    grads = np.frombuffer(grads_bytes, np.float32).reshape(n, dim)
    _served(name).push(table_id, ids, grads)
    return True


def _remote_merge(name, table_id, ids_bytes, deltas_bytes, n, dim):
    ids = np.frombuffer(ids_bytes, np.uint64, count=n)
    deltas = np.frombuffer(deltas_bytes, np.float32).reshape(n, dim)
    _served(name).merge(table_id, ids, deltas)
    return True


def _remote_save(name, dirname):
    _served(name).save(dirname)
    return True


def _remote_load(name, dirname):
    _served(name).load(dirname)
    return True


def _remote_stats(name):
    return _served(name).stats()


class LocalChannel:
    """Direct in-process channel (single-host PS, tests)."""

    def __init__(self, server: PsServer):
        self.server = server

    def pull(self, table_id, ids):
        return self.server.pull(table_id, ids)

    def push(self, table_id, ids, grads):
        self.server.push(table_id, ids, grads)

    def merge(self, table_id, ids, deltas):
        self.server.merge(table_id, ids, deltas)

    def save(self, dirname):
        self.server.save(dirname)

    def load(self, dirname):
        self.server.load(dirname)

    def stats(self):
        return self.server.stats()


class RpcChannel:
    """Cross-host channel over paddle_tpu_torch.distributed.rpc."""

    def __init__(self, worker_name: str, served_name: str = "default",
                 emb_dims: dict[int, int] | None = None):
        self.worker = worker_name
        self.name = served_name
        self.emb_dims = emb_dims or {}

    def _dim(self, table_id):
        try:
            return self.emb_dims[table_id]
        except KeyError:
            raise KeyError(f"RpcChannel needs emb_dims[{table_id}] to "
                           "decode pull payloads") from None

    def pull(self, table_id, ids):
        from .. import rpc
        ids = np.ascontiguousarray(ids, np.uint64)
        raw = rpc.rpc_sync(self.worker, _remote_pull,
                           (self.name, table_id, ids.tobytes(), ids.size))
        return np.frombuffer(raw, np.float32).reshape(
            ids.size, self._dim(table_id)).copy()

    def push(self, table_id, ids, grads):
        from .. import rpc
        ids = np.ascontiguousarray(ids, np.uint64)
        g = np.ascontiguousarray(grads, np.float32)
        rpc.rpc_sync(self.worker, _remote_push,
                     (self.name, table_id, ids.tobytes(), g.tobytes(),
                      ids.size, g.shape[-1]))

    def merge(self, table_id, ids, deltas):
        from .. import rpc
        ids = np.ascontiguousarray(ids, np.uint64)
        d = np.ascontiguousarray(deltas, np.float32)
        rpc.rpc_sync(self.worker, _remote_merge,
                     (self.name, table_id, ids.tobytes(), d.tobytes(),
                      ids.size, d.shape[-1]))

    def save(self, dirname):
        from .. import rpc
        rpc.rpc_sync(self.worker, _remote_save, (self.name, dirname))

    def load(self, dirname):
        from .. import rpc
        rpc.rpc_sync(self.worker, _remote_load, (self.name, dirname))

    def stats(self):
        from .. import rpc
        return rpc.rpc_sync(self.worker, _remote_stats, (self.name,))


class PsClient:
    """Routes pulls/pushes to owner servers; dedups and pre-aggregates.

    reference: ps_client.cc PullSparse/PushSparse request fan-out; the
    communicator's gradient aggregation (communicator.cc) is the
    np.add.at pre-aggregation here — one row update per unique id per push
    regardless of how often it repeats in the batch.
    """

    def __init__(self, channels: list):
        self.channels = channels
        self.n = len(channels)
        self._pool = ThreadPoolExecutor(max_workers=max(2, self.n))

    def pull(self, table_id: int, ids) -> np.ndarray:
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.uint64)
        uniq, inv = np.unique(ids, return_inverse=True)
        return self.pull_unique(table_id, uniq)[inv]

    def pull_unique(self, table_id: int, uniq_ids) -> np.ndarray:
        """Pull already-unique ids (the embedding layer dedups on device)."""
        uniq = np.ascontiguousarray(np.asarray(uniq_ids).reshape(-1),
                                    np.uint64)
        if uniq.size == 0:
            # delegate so the (0, emb_dim) width comes from the table
            return self.channels[0].pull(table_id, uniq)
        owners = owner_of(uniq, self.n)
        rows = None
        futs = {}
        for s in range(self.n):
            sel = np.nonzero(owners == s)[0]
            if sel.size == 0:
                continue
            futs[s] = (sel, self._pool.submit(
                self.channels[s].pull, table_id, uniq[sel]))
        for s, (sel, fut) in futs.items():
            part = fut.result()
            if rows is None:
                rows = np.empty((uniq.size, part.shape[1]), np.float32)
            rows[sel] = part
        return rows

    def push(self, table_id: int, ids, grads) -> None:
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.uint64)
        grads = np.asarray(grads, np.float32).reshape(ids.size, -1)
        uniq, inv = np.unique(ids, return_inverse=True)
        agg = np.zeros((uniq.size, grads.shape[1]), np.float32)
        np.add.at(agg, inv, grads)
        self._push_unique(table_id, uniq, agg, "push")

    def push_unique(self, table_id: int, uniq_ids, grads) -> None:
        uniq = np.ascontiguousarray(np.asarray(uniq_ids).reshape(-1),
                                    np.uint64)
        g = np.asarray(grads, np.float32).reshape(uniq.size, -1)
        self._push_unique(table_id, uniq, g, "push")

    def merge(self, table_id: int, ids, deltas) -> None:
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.uint64)
        d = np.asarray(deltas, np.float32).reshape(ids.size, -1)
        self._push_unique(table_id, ids, d, "merge")

    def _push_unique(self, table_id, uniq, payload, op):
        owners = owner_of(uniq, self.n)
        futs = []
        for s in range(self.n):
            sel = np.nonzero(owners == s)[0]
            if sel.size == 0:
                continue
            fn = getattr(self.channels[s], op)
            futs.append(self._pool.submit(fn, table_id, uniq[sel],
                                          payload[sel]))
        for f in futs:
            f.result()

    def save(self, dirname: str) -> None:
        for c in self.channels:
            c.save(dirname)

    def load(self, dirname: str) -> None:
        for c in self.channels:
            c.load(dirname)

    def stats(self) -> list[dict]:
        return [c.stats() for c in self.channels]


class GeoWorkerCache:
    """Geo-async SGD worker cache (reference memory_sparse_geo_table.cc +
    communicator GeoCommunicator): train against a LOCAL shadow table,
    every `geo_step` pushes accumulated weight DELTAS (not gradients) to
    the servers and refreshes the local rows — eventual consistency with a
    bounded staleness of geo_step optimizer steps."""

    def __init__(self, client: PsClient, table_id: int, emb_dim: int,
                 accessor: CtrAccessor | None = None, geo_step: int = 8):
        self.client = client
        self.table_id = int(table_id)
        self.emb_dim = int(emb_dim)
        self.local = SparseTable(emb_dim, accessor)
        self.base: dict[int, np.ndarray] = {}
        self.touched: set[int] = set()
        self.geo_step = int(geo_step)
        self._step = 0

    def pull(self, ids) -> np.ndarray:
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.uint64)
        missing = np.array([i for i in np.unique(ids).tolist()
                            if i not in self.base], np.uint64)
        if missing.size:
            fresh = self.client.pull_unique(self.table_id, missing)
            self.local.assign(missing, fresh)
            for j, fid in enumerate(missing.tolist()):
                self.base[fid] = fresh[j].copy()
        return self.local.pull(ids)

    def push(self, ids, grads) -> None:
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.uint64)
        if any(int(i) not in self.base for i in np.unique(ids).tolist()):
            self.pull(ids)  # establish base rows for delta computation
        self.local.push(ids, grads)
        self.touched.update(ids.tolist())
        self._step += 1
        if self._step % self.geo_step == 0:
            self.sync()

    def sync(self) -> None:
        if not self.touched:
            return
        ids = np.fromiter(self.touched, np.uint64, count=len(self.touched))
        cur = self.local.pull(ids)
        base = np.stack([self.base[i] for i in ids.tolist()])
        delta = cur - base
        self.client.merge(self.table_id, ids, delta)
        fresh = self.client.pull_unique(self.table_id, ids)
        self.local.assign(ids, fresh)
        for j, fid in enumerate(ids.tolist()):
            self.base[fid] = fresh[j].copy()
        self.touched.clear()
