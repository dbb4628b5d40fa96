"""Persistent compile cache: on-disk rewritten programs.

reference: paddle_tpu/pir/cache.py (after paddle/fluid/pir/
serialize_deserialize/ and the inference program cache). The reference's
artifact is a serialized StableHLO program; the port's is the rewritten
pir.Program itself (pir/serialize.py: JSON and raw constant bytes, no
pickle), whose `pt.*` ops call the registered K1/K2 operators.

Contract (RESILIENCE.md discipline):

* artifacts are sha256-verified on read; any mismatch, truncation or bad
  magic raises the TYPED `CompileCacheCorruptionError` and the pipeline
  falls back to a fresh compile, counting `compile_cache_corrupt_total`;
  corruption can never produce a wrong program, only a slower start;
* writes are atomic (tmp + os.replace) and size-capped by an LRU
  (`FLAGS_compile_cache_max_bytes`, least recently read first);
* `compile.cache_read` / `compile.cache_write` are registered fault
  sites, drilled by tools/chaos_drill.py.

Layout: `<dir>/<key>.pirc` =
`b"PIRC" + u32 header_len + header_json + payload`, the header holding the
payload's sha256 and provenance.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading

__all__ = ["CompileCache", "CompileCacheCorruptionError", "default_cache",
           "cache_key", "stats_snapshot"]

_MAGIC = b"PIRC"
_SUFFIX = ".pirc"

# process-local counters, independent of the observability layer so
# bench.py can report hit/miss even with metrics disabled
_STATS = {"hit": 0, "miss": 0, "write": 0, "corrupt": 0, "evict": 0,
          "read_error": 0, "write_error": 0}
_STATS_LOCK = threading.Lock()


def _bump(k, v=1):
    with _STATS_LOCK:
        _STATS[k] += v


def stats_snapshot() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


class CompileCacheCorruptionError(RuntimeError):
    """A cached compile artifact failed verification (bad magic, short
    file, or payload sha256 mismatch). Names the offending file."""


def _metric(name, **labels):
    try:
        from ..observability.catalog import metric
        return metric(name, **labels)
    except Exception:  # noqa: BLE001 — cache never fails over metrics
        class _Nop:
            def inc(self, v=1):
                pass

            def set(self, v):
                pass
        return _Nop()


def device_key(device=None) -> str:
    """The card's name and compute capability ("NVIDIA H100 80GB HBM3
    sm_90"), or "cpu": what the reference keys as the platform."""
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"{torch.cuda.get_device_name(dev)} sm_{major}{minor}"


def cache_key(canonical_hash: str, *, sharding: str = "replicated",
              device=None, extra: dict = None) -> str:
    """Artifact key: (canonical IR hash, sharding spec, the flags that
    change what the program computes or routes, torch version, device,
    pipeline version)."""
    import torch

    from ..framework import flags as _flags
    from .passes import PIPELINE_VERSION

    env = {
        "ir": canonical_hash,
        "sharding": sharding,
        "torch": torch.__version__,
        "device": device_key(device),
        "pipeline": PIPELINE_VERSION,
        "flags": {k: _flags.flag_value(k) for k in (
            "flash_attention_backend", "flash_attention_bwd",
            "attention_router", "attention_ledger_path", "pir_passes")},
    }
    if extra:
        env["extra"] = {k: str(v) for k, v in sorted(extra.items())}
    text = json.dumps(env, sort_keys=True, default=str)
    return hashlib.sha256(text.encode()).hexdigest()


class CompileCache:
    def __init__(self, directory: str, max_bytes: int = 1 << 28):
        self.dir = directory
        self.max_bytes = int(max_bytes)
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key + _SUFFIX)

    # -- read ---------------------------------------------------------------
    def get(self, key: str):
        """Return (payload_bytes, meta_dict) or None on miss. Raises
        CompileCacheCorruptionError on a failed verification, OSError-
        family on IO trouble (callers treat both as recompile)."""
        from ..resilience.faults import fault_point
        path = self._path(key)
        if not os.path.exists(path):
            return None
        fault_point("compile.cache_read", path=path)
        with open(path, "rb") as f:
            blob = f.read()
        if len(blob) < 8 or blob[:4] != _MAGIC:
            raise CompileCacheCorruptionError(
                f"compile-cache artifact {path} has a bad header "
                "(magic mismatch)")
        (hlen,) = struct.unpack("<I", blob[4:8])
        if len(blob) < 8 + hlen:
            raise CompileCacheCorruptionError(
                f"compile-cache artifact {path} is truncated")
        try:
            header = json.loads(blob[8:8 + hlen].decode())
        except Exception as e:
            raise CompileCacheCorruptionError(
                f"compile-cache artifact {path} has an unreadable "
                f"header: {e}") from None
        payload = blob[8 + hlen:]
        digest = hashlib.sha256(payload).hexdigest()
        if digest != header.get("sha256"):
            raise CompileCacheCorruptionError(
                f"compile-cache artifact {path} failed sha256 "
                f"verification (have {digest[:12]}, "
                f"recorded {str(header.get('sha256'))[:12]})")
        os.utime(path, None)          # LRU recency = last verified read
        return payload, header.get("meta", {})

    # -- write --------------------------------------------------------------
    def put(self, key: str, payload: bytes, meta: dict = None):
        from ..resilience.faults import fault_point
        path = self._path(key)
        header = json.dumps({
            "sha256": hashlib.sha256(payload).hexdigest(),
            "meta": meta or {},
        }).encode()
        tmp = path + f".tmp.{os.getpid()}"
        fault_point("compile.cache_write", path=path)
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            f.write(payload)
        os.replace(tmp, path)
        self._evict()

    def drop(self, key: str):
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    # -- eviction -----------------------------------------------------------
    def entries(self):
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            if not n.endswith(_SUFFIX):
                continue
            p = os.path.join(self.dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((p, st.st_mtime, st.st_size))
        return out

    def total_bytes(self) -> int:
        return sum(sz for _, _, sz in self.entries())

    def _evict(self):
        """Size-capped LRU: drop least-recently-read artifacts until the
        directory fits max_bytes."""
        ents = self.entries()
        total = sum(sz for _, _, sz in ents)
        _metric("compile_cache_bytes").set(total)
        if total <= self.max_bytes:
            return
        evicted = 0
        for p, _, sz in sorted(ents, key=lambda e: e[1]):
            if total <= self.max_bytes:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= sz
            evicted += 1
        if evicted:
            _bump("evict", evicted)
            _metric("compile_cache_evict_total").inc(evicted)
            _metric("compile_cache_bytes").set(total)


def default_cache():
    """CompileCache from FLAGS_compile_cache_dir ('' = disabled)."""
    from ..framework import flags as _flags
    d = _flags.flag_value("compile_cache_dir")
    if not d:
        return None
    return CompileCache(d, _flags.flag_value("compile_cache_max_bytes"))
