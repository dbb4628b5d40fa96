"""Rendezvous stores. reference: paddle_tpu/distributed/store.py (`Store`,
`TCPStore`, `ResilientStore`), after paddle/phi/core/distributed/store/
(store.h, tcp_store.h:121).

The server and client are the port's own copy of the reference's C++
store (`csrc/tcp_store.cc`), built by g++ at first use into
`paddle_tpu_torch/_build/` and bound with ctypes; blocking waits happen
server-side on a condvar, as in the reference. There is no in-process
stand-in: where the build fails, making a TCPStore raises.
"""

from __future__ import annotations

import ctypes
import threading

from ..ops._build import host_library
from ..resilience.faults import fault_point
from ..resilience.retry import RetryPolicy

__all__ = ["Store", "TCPStore", "ResilientStore"]

_LIB: list = []
_LOCK = threading.Lock()


def _bind(lib):
    c = ctypes
    sigs = {
        "pt_store_server_start": ([c.c_int], c.c_void_p),
        "pt_store_server_port": ([c.c_void_p], c.c_int),
        "pt_store_server_stop": ([c.c_void_p], None),
        "pt_store_client_new": ([c.c_char_p, c.c_int, c.c_int], c.c_void_p),
        "pt_store_client_free": ([c.c_void_p], None),
        "pt_store_set": ([c.c_void_p, c.c_char_p, c.POINTER(c.c_uint8),
                          c.c_int64], c.c_int),
        "pt_store_get": ([c.c_void_p, c.c_char_p, c.c_int64,
                          c.POINTER(c.c_int64)], c.POINTER(c.c_uint8)),
        "pt_buffer_free": ([c.c_void_p], None),
        "pt_store_add": ([c.c_void_p, c.c_char_p, c.c_int64,
                          c.POINTER(c.c_int64)], c.c_int),
        "pt_store_wait": ([c.c_void_p, c.c_char_p, c.c_int64], c.c_int),
        "pt_store_delete": ([c.c_void_p, c.c_char_p], c.c_int),
        "pt_store_check": ([c.c_void_p, c.c_char_p], c.c_int),
        "pt_store_num_keys": ([c.c_void_p], c.c_int64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def library():
    """The store's shared library, built by g++ on first use."""
    with _LOCK:
        if not _LIB:
            _LIB.append(_bind(ctypes.CDLL(str(
                host_library("tcp_store.cc", "store")))))
    return _LIB[0]


class Store:
    """The store API (reference: store/store.h)."""

    def set(self, key: str, value):
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        raise NotImplementedError

    def wait(self, key: str):
        raise NotImplementedError


class TCPStore(Store):
    """The master rank (is_master=True) starts the server (port 0: any free
    port, read back from `port`); every rank, the master too, connects a
    client. get and wait block server-side for up to `timeout` seconds."""

    def __init__(self, host="127.0.0.1", port=6170, is_master=False,
                 world_size=1, timeout=900, stop_check_timeout=None):
        self._host = host
        self._port = int(port)
        self._timeout_s = timeout if timeout and timeout > 0 else 900
        self._world_size = world_size
        self._server = None
        self._client = None
        self._barrier_rounds = {}
        lib = self._lib = library()
        if is_master:
            self._server = lib.pt_store_server_start(self._port)
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {self._port}")
            self._port = lib.pt_store_server_port(self._server)
        self._client = lib.pt_store_client_new(
            host.encode(), self._port, int(self._timeout_s * 1000))
        if not self._client:
            if self._server:
                lib.pt_store_server_stop(self._server)
                self._server = None
            raise RuntimeError(
                f"TCPStore: cannot connect to {host}:{self._port}")

    @property
    def port(self):
        return self._port

    def set(self, key, value):
        fault_point("store.set", key=key)
        if isinstance(value, str):
            value = value.encode()
        buf = (ctypes.c_uint8 * len(value)).from_buffer_copy(value) \
            if value else (ctypes.c_uint8 * 1)()
        if self._lib.pt_store_set(self._client, key.encode(), buf,
                                  len(value)) != 0:
            raise RuntimeError(f"TCPStore.set({key!r}) failed")

    def get(self, key):
        fault_point("store.get", key=key)
        out_len = ctypes.c_int64()
        ptr = self._lib.pt_store_get(self._client, key.encode(),
                                     int(self._timeout_s * 1000),
                                     ctypes.byref(out_len))
        if not ptr or out_len.value < 0:
            raise TimeoutError(f"TCPStore.get({key!r}) timed out")
        try:
            return ctypes.string_at(ptr, out_len.value)
        finally:
            self._lib.pt_buffer_free(ptr)

    def add(self, key, amount):
        out = ctypes.c_int64()
        if self._lib.pt_store_add(self._client, key.encode(), int(amount),
                                  ctypes.byref(out)) != 0:
            raise RuntimeError(f"TCPStore.add({key!r}) failed")
        return out.value

    def wait(self, key):
        if self._lib.pt_store_wait(self._client, key.encode(),
                                   int(self._timeout_s * 1000)) != 0:
            raise TimeoutError(f"TCPStore.wait({key!r}) timed out")

    def delete_key(self, key):
        return self._lib.pt_store_delete(self._client, key.encode()) == 0

    def check(self, key):
        return self._lib.pt_store_check(self._client, key.encode()) == 1

    def num_keys(self):
        return self._lib.pt_store_num_keys(self._client)

    def barrier(self, tag="barrier"):
        """All world_size ranks arrive before any leaves. Reusable: each
        call on a tag advances a local round, so keys never collide across
        rounds (every rank calls barrier the same number of times)."""
        _barrier(self, self._world_size, tag)

    def close(self):
        """Free the client, and stop the server on the master."""
        if self._client:
            self._lib.pt_store_client_free(self._client)
            self._client = None
        if self._server:
            self._lib.pt_store_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def _barrier(store, world_size, tag):
    rounds = store._barrier_rounds
    r = rounds.get(tag, 0)
    rounds[tag] = r + 1
    count = store.add(f"__barrier/{tag}/{r}/count", 1)
    if count == world_size:
        store.set(f"__barrier/{tag}/{r}/done", b"1")
    store.wait(f"__barrier/{tag}/{r}/done")


class ResilientStore(Store):
    """A Store whose calls go through a RetryPolicy (jittered backoff) and,
    optionally, a CircuitBreaker, so transient failures are retried and a
    hard-down store fails fast:

        store = ResilientStore(TCPStore(...),
                               policy=RetryPolicy(max_attempts=4))

    Exceptions outside policy.retry_on pass through untouched."""

    def __init__(self, store, policy=None, breaker=None):
        self._inner = store
        self._policy = policy or RetryPolicy()
        self._breaker = breaker
        self._barrier_rounds = {}

    @property
    def inner(self):
        return self._inner

    def __getattr__(self, name):
        # anything beyond the retried API (port, ...) is the wrapped store's
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def _call(self, op, fn, *args):
        if self._breaker is not None:
            return self._breaker.call(self._policy.call, fn, *args, op=op)
        return self._policy.call(fn, *args, op=op)

    def set(self, key, value):
        return self._call("store.set", self._inner.set, key, value)

    def get(self, key):
        return self._call("store.get", self._inner.get, key)

    def add(self, key, amount):
        return self._call("store.add", self._inner.add, key, amount)

    def wait(self, key):
        return self._call("store.wait", self._inner.wait, key)

    def delete_key(self, key):
        return self._call("store.delete", self._inner.delete_key, key)

    def check(self, key):
        return self._call("store.check", self._inner.check, key)

    def num_keys(self):
        return self._call("store.num_keys", self._inner.num_keys)

    def barrier(self, tag="barrier"):
        # through the retried add/set/wait, so each leg is retried
        _barrier(self, getattr(self._inner, "_world_size", 1), tag)
