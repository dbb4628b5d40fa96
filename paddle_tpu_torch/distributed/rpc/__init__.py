"""paddle.distributed.rpc. reference: paddle_tpu/distributed/rpc/
__init__.py (`WorkerInfo` :27, `init_rpc` :82, `rpc_sync` :151,
`rpc_async` :156, `shutdown` :164), after python/paddle/distributed/rpc/
rpc.py.

Control-plane RPC: a function and its arguments pickled over TCP with
multiprocessing.connection, authenticated by a per-job key that rank 0
puts in the rendezvous store, the port's TCPStore (csrc/tcp_store.cc);
each worker registers its WorkerInfo there and reads everyone's. The
callee resolves the function by its qualified name, so it must be
importable on the callee's side. Tensors travel pickled; bulk tensor
traffic belongs on the collectives.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
import secrets

from multiprocessing.connection import Client, Listener

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos", "WorkerInfo"]


class WorkerInfo:
    def __init__(self, name, rank, ip, port):
        self.name = name
        self.rank = rank
        self.ip = ip
        self.port = port

    def __repr__(self):
        return (f"WorkerInfo(name={self.name}, rank={self.rank}, "
                f"ip={self.ip}, port={self.port})")


class _State:
    def __init__(self):
        self.name = None
        self.rank = None
        self.store = None
        self.listener = None
        self.serve_thread = None
        self.pool = None
        self.workers = {}
        self.auth = None
        self.stop = threading.Event()


_state = _State()


def _serve(listener, stop):
    while not stop.is_set():
        try:
            conn = listener.accept()
        except (OSError, EOFError):
            if stop.is_set():
                return
            continue

        def handle(c):
            try:
                while not stop.is_set():
                    try:
                        fn, args, kwargs = c.recv()
                    except (EOFError, OSError):
                        return
                    try:
                        result = ("ok", fn(*args, **kwargs))
                    except Exception as e:  # noqa: BLE001 — ship to caller
                        result = ("err", e)
                    c.send(result)
            finally:
                c.close()

        threading.Thread(target=handle, args=(conn,), daemon=True).start()


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """reference: distributed/rpc/rpc.py init_rpc."""
    from ..store import TCPStore
    rank = rank if rank is not None else int(
        os.environ.get("PADDLE_TRAINER_ID", "0"))
    world_size = world_size or int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master_endpoint = master_endpoint or os.environ.get(
        "PADDLE_MASTER", "127.0.0.1:8091")
    host, port = master_endpoint.rsplit(":", 1)
    _state.store = TCPStore(host, int(port), is_master=(rank == 0),
                            world_size=world_size, timeout=120)
    # per-job random authkey distributed through the rendezvous store (the
    # trust root, like the reference master endpoint) — RPC executes
    # callables, so connections must prove they joined this job
    if rank == 0:
        _state.auth = secrets.token_bytes(32)
        _state.store.set("__rpc/authkey", _state.auth)
    else:
        _state.auth = bytes(_state.store.get("__rpc/authkey"))
    # bind to this worker's interface (PADDLE_RPC_BIND_IP to widen), never
    # an unconditional 0.0.0.0
    my_ip = os.environ.get("POD_IP", "127.0.0.1")
    bind_ip = os.environ.get("PADDLE_RPC_BIND_IP", my_ip)
    _state.listener = Listener((bind_ip, 0), authkey=_state.auth)
    my_port = _state.listener.address[1]
    _state.name = name
    _state.rank = rank
    _state.pool = ThreadPoolExecutor(max_workers=8)
    _state.stop.clear()
    _state.serve_thread = threading.Thread(
        target=_serve, args=(_state.listener, _state.stop), daemon=True)
    _state.serve_thread.start()
    # register + discover everyone
    _state.store.set(f"__rpc/{rank}",
                     pickle.dumps(WorkerInfo(name, rank, my_ip, my_port)))
    for r in range(world_size):
        info = pickle.loads(_state.store.get(f"__rpc/{r}"))
        _state.workers[info.name] = info
        _state.workers[info.rank] = info
    _state.store.barrier("rpc_init")


def get_worker_info(name=None):
    if name is None:
        return _state.workers[_state.rank]
    return _state.workers[name]


def get_all_worker_infos():
    return sorted({id(v): v for v in _state.workers.values()}.values(),
                  key=lambda w: w.rank)


def _call(to, fn, args, kwargs, timeout):
    info = _state.workers[to]
    conn = Client((info.ip, info.port), authkey=_state.auth)
    try:
        conn.send((fn, args or (), kwargs or {}))
        if timeout and timeout > 0:
            if not conn.poll(timeout):
                raise TimeoutError(f"rpc to {to} timed out after {timeout}s")
        status, payload = conn.recv()
    finally:
        conn.close()
    if status == "err":
        raise payload
    return payload


def rpc_sync(to, fn, args=None, kwargs=None, timeout=-1):
    """reference: rpc.py rpc_sync — blocking remote call."""
    return _call(to, fn, args, kwargs, timeout)


def rpc_async(to, fn, args=None, kwargs=None, timeout=-1) -> Future:
    """reference: rpc.py rpc_async — returns a Future (.wait() alias)."""
    fut = _state.pool.submit(_call, to, fn, args, kwargs, timeout)
    if not hasattr(fut, "wait"):
        fut.wait = fut.result
    return fut


def shutdown():
    """reference: rpc.py shutdown — barrier then teardown."""
    if _state.store is not None:
        try:
            _state.store.barrier("rpc_shutdown")
        except Exception:  # noqa: BLE001 — peers may already be gone
            pass
    _state.stop.set()
    if _state.listener is not None:
        try:
            _state.listener.close()
        except OSError:
            pass
    if _state.pool is not None:
        _state.pool.shutdown(wait=False)
    _state.__init__()
