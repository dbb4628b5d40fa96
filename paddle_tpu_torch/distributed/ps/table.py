"""Sparse and dense parameter-server tables: host-resident row stores.
reference: paddle_tpu/distributed/ps/table.py (`SparseTable` :35,
`DenseTable` :352), after paddle/fluid/distributed/ps/table/
(memory_sparse_table.cc, memory_dense_table.cc).

The rows live in host memory, in the native store (csrc/ps_table.cc, the
reference's native/ps_table.cc, built by g++ at first use into
paddle_tpu_torch/_build/ and bound with ctypes, which releases the GIL),
or, where that build fails or use_native=False, in a numpy store with the
same deterministic miss-init and rules. The native store's checkpoint is
the reference's binary format, so either package loads a table the other
saved. The device sees only the rows a batch pulls (ps/embedding.py).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .accessor import (CtrAccessor, SparseAdaGradRule, _RuleBase,
                       deterministic_init, deterministic_init_batch)

__all__ = ["SparseTable", "DenseTable"]

_LIB: list = []          # [CDLL] once built, [None] once the build failed
_LIB_LOCK = threading.Lock()


def _bind(lib):
    c = ctypes
    u64p, f32p = c.POINTER(c.c_uint64), c.POINTER(c.c_float)
    sigs = {
        "pt_ps_table_new": ([c.c_int, c.c_int] + [c.c_float] * 5,
                            c.c_void_p),
        "pt_ps_table_free": ([c.c_void_p], None),
        "pt_ps_table_pull": ([c.c_void_p, u64p, c.c_int64, f32p, c.c_int],
                             None),
        "pt_ps_table_push": ([c.c_void_p, u64p, c.c_int64, f32p], None),
        "pt_ps_table_merge": ([c.c_void_p, u64p, c.c_int64, f32p], None),
        "pt_ps_table_assign": ([c.c_void_p, u64p, c.c_int64, f32p], None),
        "pt_ps_table_size": ([c.c_void_p], c.c_int64),
        "pt_ps_table_contains": ([c.c_void_p, u64p, c.c_int64,
                                  c.POINTER(c.c_uint8)], None),
        "pt_ps_table_keys": ([c.c_void_p, u64p, c.c_int64], c.c_int64),
        "pt_ps_table_add_show_click": ([c.c_void_p, u64p, c.c_int64, f32p,
                                        f32p], None),
        "pt_ps_table_decay": ([c.c_void_p, c.c_float], None),
        "pt_ps_table_shrink": ([c.c_void_p, c.c_float, c.c_float],
                               c.c_int64),
        "pt_ps_table_save": ([c.c_void_p, c.c_char_p], c.c_int),
        "pt_ps_table_load": ([c.c_void_p, c.c_char_p], c.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def native_lib():
    """The table's library (csrc/ps_table.cc), built by g++ on first use;
    None where the build fails (the tables then keep their rows in numpy)."""
    with _LIB_LOCK:
        if not _LIB:
            from ...ops._build import host_library
            try:
                _LIB.append(_bind(ctypes.CDLL(str(
                    host_library("ps_table.cc", "ps_table")))))
            except (OSError, RuntimeError):
                _LIB.append(None)
    return _LIB[0]


def _as_ids(ids) -> np.ndarray:
    a = np.asarray(ids)
    if a.dtype != np.uint64:
        a = a.astype(np.uint64)
    return np.ascontiguousarray(a.reshape(-1))


class SparseTable:
    """id -> embedding row store with a per-row optimizer rule.

    Native-backed when the toolchain built (default); the numpy fallback is
    semantically identical (same deterministic miss-init, same rules).
    """

    def __init__(self, emb_dim: int, accessor: CtrAccessor | None = None,
                 use_native: bool | None = None):
        self.emb_dim = int(emb_dim)
        self.accessor = accessor or CtrAccessor(SparseAdaGradRule())
        rule = self.accessor.rule
        # RLock: the entry-admission gate wraps contains()/pull()/apply
        # under one critical section (gated tables serialize pull vs push
        # — a two-step contains+read would otherwise race a concurrent
        # admission and mask a freshly stored row with its init values)
        self._lock = threading.RLock()
        lib = native_lib() if use_native or use_native is None else None
        self._native = lib is not None
        # feature-admission policy (reference entry_attr.py): probationary
        # ids live only in this counter until the policy admits them — the
        # row store never sees a rejected feature. The counter is bounded
        # (FIFO eviction) so permanently-rejected id streams cannot bloat
        # the host dict the way they would have bloated the table.
        self._entry = self.accessor.entry
        self._probation: dict[int, int] = {}
        self._probation_cap = 1_000_000
        if self._native:
            self._h = native_lib().pt_ps_table_new(
                self.emb_dim, rule.rule_id, rule.learning_rate,
                rule.initial_range, rule.eps, rule.beta1, rule.beta2)
            if not self._h:
                raise RuntimeError("pt_ps_table_new failed")
        else:
            # fallback store: id -> [w, slots, meta(show, click, unseen)]
            self._rows: dict[int, list[np.ndarray]] = {}

    # --- fallback helpers --------------------------------------------------
    def _row(self, fid: int, create: bool):
        r = self._rows.get(fid)
        if r is None and create:
            rule = self.accessor.rule
            r = [deterministic_init(fid, self.emb_dim, rule.initial_range),
                 rule.init_slots(self.emb_dim),
                 np.zeros(3, np.float32)]
            self._rows[fid] = r
        return r

    def contains(self, ids) -> np.ndarray:
        """Membership mask (no row creation)."""
        ids = _as_ids(ids)
        if self._native:
            out = np.empty(ids.size, np.uint8)
            native_lib().pt_ps_table_contains(
                self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ids.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            return out.astype(bool)
        with self._lock:
            return np.array([fid in self._rows for fid in ids.tolist()],
                            bool)

    # --- entry-admission gate (reference entry_attr.py) --------------------
    def _gate_writes(self, ids, payload):
        """Filter a gradient-bearing write down to admitted occurrences and
        update probation counters. Caller holds self._lock. In-batch
        duplicates: the occurrence that crosses the threshold admits the id
        for the REST of the batch too (no stale counter is left behind)."""
        present = self.contains(ids)
        keep = present.copy()
        newly: set[int] = set()
        counts = getattr(self._entry, "needs_count", True)
        for i in np.nonzero(~present)[0]:
            fid = int(ids[i])
            if fid in newly:
                keep[i] = True
                continue
            n = self._probation.get(fid, 0) + 1
            if self._entry.admit(fid, n):
                self._probation.pop(fid, None)
                newly.add(fid)
                keep[i] = True
            elif counts:
                if fid not in self._probation and \
                        len(self._probation) >= self._probation_cap:
                    self._probation.pop(next(iter(self._probation)))
                self._probation[fid] = n
        if keep.all():
            return ids, payload
        return (np.ascontiguousarray(ids[keep]),
                np.ascontiguousarray(payload[keep]))

    # --- core ops ----------------------------------------------------------
    def pull(self, ids, init_on_miss: bool = True) -> np.ndarray:
        ids = _as_ids(ids)
        if self._entry is not None and init_on_miss:
            # probationary ids read their would-be init without entering
            # the store; the entry policy admits rows on gradient writes
            # only. Locked: a push admitting between contains() and the
            # raw read must not be masked by init values.
            with self._lock:
                present = self.contains(ids)
                out = self.pull(ids, init_on_miss=False)
            missing = np.nonzero(~present)[0]
            if missing.size:
                out[missing] = deterministic_init_batch(
                    ids[missing], self.emb_dim,
                    self.accessor.rule.initial_range)
            return out
        out = np.empty((ids.size, self.emb_dim), np.float32)
        if self._native:
            native_lib().pt_ps_table_pull(
                self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ids.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                1 if init_on_miss else 0)
            return out
        with self._lock:
            for i, fid in enumerate(ids.tolist()):
                r = self._row(fid, init_on_miss)
                if r is None:
                    out[i] = 0.0
                else:
                    out[i] = r[0]
                    r[2][2] = 0.0  # unseen_days reset
        return out

    def push(self, ids, grads) -> None:
        ids = _as_ids(ids)
        grads = np.ascontiguousarray(
            np.asarray(grads, np.float32).reshape(ids.size, self.emb_dim))
        if self._entry is not None:
            # gate + apply under one lock so gated pulls see either the
            # pre-admission or post-apply state, never a half state
            with self._lock:
                ids, grads = self._gate_writes(ids, grads)
                if ids.size == 0:
                    return
                self._apply_push(ids, grads)
            return
        self._apply_push(ids, grads)

    def _apply_push(self, ids, grads) -> None:
        if self._native:
            native_lib().pt_ps_table_push(
                self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ids.size,
                grads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return
        rule = self.accessor.rule
        with self._lock:
            for i, fid in enumerate(ids.tolist()):
                r = self._row(fid, True)
                rule.apply(r[0], r[1], grads[i])

    def merge(self, ids, deltas) -> None:
        """Additive weight merge (geo-SGD delta application; reference
        memory_sparse_geo_table.cc) — bypasses the optimizer rule. Geo
        workers deliver their training updates through here, so the entry
        gate applies exactly as it does for push."""
        ids = _as_ids(ids)
        deltas = np.ascontiguousarray(
            np.asarray(deltas, np.float32).reshape(ids.size, self.emb_dim))
        if self._entry is not None:
            with self._lock:
                ids, deltas = self._gate_writes(ids, deltas)
                if ids.size == 0:
                    return
                self._apply_merge(ids, deltas)
            return
        self._apply_merge(ids, deltas)

    def _apply_merge(self, ids, deltas) -> None:
        if self._native:
            native_lib().pt_ps_table_merge(
                self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ids.size,
                deltas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return
        with self._lock:
            for i, fid in enumerate(ids.tolist()):
                self._row(fid, True)[0] += deltas[i]

    def assign(self, ids, rows) -> None:
        ids = _as_ids(ids)
        rows = np.ascontiguousarray(
            np.asarray(rows, np.float32).reshape(ids.size, self.emb_dim))
        if self._native:
            native_lib().pt_ps_table_assign(
                self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ids.size,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return
        with self._lock:
            for i, fid in enumerate(ids.tolist()):
                self._row(fid, True)[0][:] = rows[i]

    # --- lifecycle ---------------------------------------------------------
    def __len__(self) -> int:
        if self._native:
            return int(native_lib().pt_ps_table_size(self._h))
        with self._lock:
            return len(self._rows)

    def keys(self) -> np.ndarray:
        if self._native:
            n = len(self)
            out = np.empty(n, np.uint64)
            got = native_lib().pt_ps_table_keys(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                n)
            return out[:got]
        with self._lock:
            return np.fromiter(self._rows.keys(), np.uint64,
                               count=len(self._rows))

    def add_show_click(self, ids, shows, clicks) -> None:
        ids = _as_ids(ids)
        shows = np.ascontiguousarray(np.asarray(shows, np.float32).reshape(-1))
        clicks = np.ascontiguousarray(
            np.asarray(clicks, np.float32).reshape(-1))
        if self._entry is not None:
            # stats never admit: update existing rows only (admission is a
            # gradient-write decision; un-admitted features drop stats)
            with self._lock:
                present = self.contains(ids)
                if not present.all():
                    ids = np.ascontiguousarray(ids[present])
                    shows = np.ascontiguousarray(shows[present])
                    clicks = np.ascontiguousarray(clicks[present])
                if ids.size == 0:
                    return
                return self._apply_show_click(ids, shows, clicks)
        self._apply_show_click(ids, shows, clicks)

    def _apply_show_click(self, ids, shows, clicks) -> None:
        if self._native:
            native_lib().pt_ps_table_add_show_click(
                self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ids.size,
                shows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                clicks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return
        with self._lock:
            for i, fid in enumerate(ids.tolist()):
                m = self._row(fid, True)[2]
                m[0] += shows[i]
                m[1] += clicks[i]

    def decay(self, rate: float | None = None) -> None:
        rate = self.accessor.show_decay_rate if rate is None else float(rate)
        if self._native:
            native_lib().pt_ps_table_decay(self._h, rate)
            return
        with self._lock:
            for r in self._rows.values():
                r[2][0] *= rate
                r[2][1] *= rate
                r[2][2] += 1.0

    def shrink(self) -> int:
        acc = self.accessor
        if self._native:
            return int(native_lib().pt_ps_table_shrink(
                self._h, acc.shrink_show_threshold, acc.shrink_unseen_days))
        with self._lock:
            dead = [fid for fid, r in self._rows.items()
                    if r[2][0] < acc.shrink_show_threshold
                    and r[2][2] >= acc.shrink_unseen_days]
            for fid in dead:
                del self._rows[fid]
            return len(dead)

    def save(self, path: str) -> None:
        if self._native:
            rc = native_lib().pt_ps_table_save(self._h, path.encode())
            if rc != 0:
                raise IOError(f"ps table save failed rc={rc}: {path}")
            return
        import os
        with self._lock:
            ids = np.fromiter(self._rows.keys(), np.uint64,
                              count=len(self._rows))
            # atomic replace: a failed save must not destroy the previous
            # checkpoint. Explicit .npz suffix keeps np.savez from
            # renaming the temp file.
            tmp = path + ".tmp.npz"
            np.savez(tmp, ids=ids,
                     w=np.stack([self._rows[int(i)][0] for i in ids])
                     if ids.size else np.zeros((0, self.emb_dim), np.float32),
                     slots=np.stack([self._rows[int(i)][1] for i in ids])
                     if ids.size else np.zeros((0, 0), np.float32),
                     meta=np.stack([self._rows[int(i)][2] for i in ids])
                     if ids.size else np.zeros((0, 3), np.float32))
            target = path if path.endswith(".npz") else path + ".npz"
            os.replace(tmp, target)

    def load(self, path: str) -> None:
        if self._native:
            rc = native_lib().pt_ps_table_load(self._h, path.encode())
            if rc != 0:
                raise IOError(f"ps table load failed rc={rc}: {path}")
            return
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            with self._lock:
                for i, fid in enumerate(z["ids"].tolist()):
                    self._rows[fid] = [z["w"][i].copy(), z["slots"][i].copy(),
                                       z["meta"][i].copy()]

    def __del__(self):  # pragma: no cover - interpreter teardown ordering
        try:
            if getattr(self, "_native", False) and getattr(self, "_h", None):
                native_lib().pt_ps_table_free(self._h)
                self._h = None
        except Exception:
            pass


class DenseTable:
    """Versioned dense parameter block (reference memory_dense_table.cc).

    The dense model trains on the card; this holds the small dense
    params (biases, batch-norm stats) that recsys jobs keep on the server.
    Updates are plain SGD on the server; workers pull snapshots.
    """

    def __init__(self, shape, learning_rate: float = 0.05):
        self.value = np.zeros(shape, np.float32)
        self.learning_rate = float(learning_rate)
        self.version = 0
        self._lock = threading.Lock()

    def pull(self) -> tuple[np.ndarray, int]:
        with self._lock:
            return self.value.copy(), self.version

    def push(self, grad) -> None:
        g = np.asarray(grad, np.float32).reshape(self.value.shape)
        with self._lock:
            self.value -= self.learning_rate * g
            self.version += 1

    def assign(self, value) -> None:
        v = np.asarray(value, np.float32).reshape(self.value.shape)
        with self._lock:
            self.value[:] = v
            self.version += 1
