"""Distributed checkpoint: sharded save and reshard-on-load. reference:
paddle_tpu/distributed/checkpoint/__init__.py (its docstring :1-39), after
python/paddle/distributed/checkpoint/ (save_state_dict.py:145 per-rank
shard files and global metadata, :117 dedup of replicated tensors,
load_state_dict.py reshard-on-load, async save :46).

The on-disk format is the reference's, byte for byte, so each package
reads the other's checkpoints:
- each distinct chunk of a tensor's chunk map (distributed/placement.py;
  the whole tensor when it carries no placements) is written once, by its
  lowest owner, as one `.npy` file named `s{seq}_r{process}_{sha1}.npy`
  from the save sequence, the owning process and sha1(key, bounds); one
  process drives every process id of a mesh, so that process is 0;
- every file goes to a temporary name and is renamed into place, and
  `metadata.json` (shapes, dtypes, each chunk's bounds, file and sha256)
  is replaced last; the save sequence is the previous metadata's plus one,
  so a save killed between its chunk writes and the metadata leaves the
  previous checkpoint whole; the next committed save deletes chunk files
  no metadata names (keeping the previous sequence's);
- the fault sites `ckpt.chunk_write` and `ckpt.metadata_replace` make both
  windows drillable, and IO is retried by resilience.RetryPolicy;
- an async save runs on a non-daemon thread, so process exit joins it;
- a load memory-maps only the chunks that overlap each destination block
  of the tensor's chunk map, checks each file's sha256 the first time it
  is read (CheckpointCorruptionError names a missing, truncated or corrupt
  file), and copies the block to the tensor's device.
bfloat16 chunks are raw 2-byte words under the reference's '<V2' header
(ml_dtypes' bfloat16 as numpy saves it), read back as torch.bfloat16.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...resilience.faults import fault_point
from ...resilience.retry import RetryPolicy
from ..parallel_env import get_rank
from ..placement import chunk_map

__all__ = ["save_state_dict", "load_state_dict",
           "CheckpointCorruptionError"]


class CheckpointCorruptionError(RuntimeError):
    """A chunk file is missing, truncated, or fails its recorded sha256.
    Carries the offending file name — never a numpy decode traceback."""

    def __init__(self, file, reason):
        super().__init__(f"checkpoint chunk {file!r} is corrupt: {reason}")
        self.file = file
        self.reason = reason


def _count(name):
    """Checkpoint telemetry (observability catalog); the save/load path
    never fails over a metrics problem."""
    try:
        from ...observability.catalog import metric
        metric(name).inc()
    except Exception:  # noqa: BLE001
        pass


# transient-IO retry for chunk/metadata writes: short, deterministic
# backoff (writes happen inside the training step cadence)
_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.02, max_delay=0.2,
                        seed=0)

_async_tasks: list[threading.Thread] = []

# what the last load_state_dict read: files opened and their data bytes
last_load_stats = {"files": 0, "bytes": 0}


def _wait_async():
    global _async_tasks
    for t in _async_tasks:
        t.join()
    _async_tasks = []


_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _norm_index(index, shape):
    """Normalize a chunk index (tuple of slices) to ((start, stop), ...)."""
    out = []
    for dim, sl in enumerate(index):
        start = 0 if sl.start is None else int(sl.start)
        stop = shape[dim] if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return tuple(out)


def _chunk_key(bounds):
    return ";".join(f"{a}:{b}" for a, b in bounds)


def _blocks(t):
    """{chunk key: (bounds, lowest owning process id)} of the tensor's
    chunk map; one chunk owned by 0 without placements."""
    shape = tuple(t.shape)
    mesh = getattr(t, "process_mesh", None)
    if mesh is None:
        bounds = tuple((0, s) for s in shape)
        return {_chunk_key(bounds): (bounds, 0)}
    groups = {}
    for pid, index in chunk_map(mesh, t.placements, shape).items():
        bounds = _norm_index(index, shape)
        key = _chunk_key(bounds)
        if key not in groups or pid < groups[key][1]:
            groups[key] = (bounds, pid)
    return groups


def _chunk_file(seq, owner_rank, key, chunk_key):
    """Deterministic per-chunk file name from (save seq, array name,
    bounds, owner). The seq prefix keeps a save that dies before its
    metadata from overwriting the files the previous metadata names."""
    h = hashlib.sha1(f"{key}\x00{chunk_key}".encode()).hexdigest()[:16]
    return f"s{seq}_r{owner_rank}_{h}.npy"


def _next_save_seq(path):
    """Previous metadata's save_seq + 1 (0 for a fresh dir)."""
    try:
        with open(os.path.join(path, "metadata.json")) as f:
            return int(json.load(f).get("save_seq", 0)) + 1
    except (OSError, ValueError):
        return 0


def _host_array(t):
    """The chunk as numpy: bfloat16 as 2-byte void words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _sha256(data):
    flat = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()


def _pool():
    """Threads for chunk IO and hashing (hashlib and file IO release the
    GIL); the results are the same as one thread's."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _write_npy(f, data):
    """np.save's bytes; a bfloat16 chunk under the '<V2' descr numpy gives
    ml_dtypes' bfloat16."""
    if data.dtype.kind != "V":
        np.save(f, data, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": "<V2", "fortran_order": False, "shape": data.shape})
    f.write(np.ascontiguousarray(data).tobytes())


def _atomic_write_npy(path, fname, data):
    fault_point("ckpt.chunk_write", file=fname)
    # pid-unique tmp: two processes that each write the same chunk never
    # interleave bytes in one file; both renames commit identical data
    tmp = os.path.join(path, f"{fname}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        _write_npy(f, data)
    os.replace(tmp, os.path.join(path, fname))


def _replace_metadata(path, meta):
    tmp = os.path.join(path, f"metadata.json.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    # the kill-mid-save window: chunks are on disk, the previous
    # metadata is still live until this replace commits the new save
    fault_point("ckpt.metadata_replace")
    os.replace(tmp, os.path.join(path, "metadata.json"))


_SEQ_RE = re.compile(r"^s(\d+)_")


def _gc_stale_chunks(path, meta):
    """After a committed save, drop chunk files no metadata references:
    old seqs' data and orphans of crashed saves. Files of the committed
    seq and the one before are kept even when unreferenced (a concurrent
    writer one save behind may still commit them). Best-effort."""
    live = {c["file"] for a in meta["arrays"].values() for c in a["chunks"]}
    keep_seq = int(meta.get("save_seq", 0)) - 1
    try:
        entries = os.listdir(path)
    except OSError:
        return
    for fname in entries:
        if fname in live or fname == "metadata.json":
            continue
        if fname.endswith(".npy") or fname.endswith(".tmp"):
            m = _SEQ_RE.match(fname)
            if m and int(m.group(1)) >= keep_seq:
                continue
            try:
                os.unlink(os.path.join(path, fname))
            except OSError:
                pass


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    async_save=False):
    """Sharded save: this process writes only the chunks it owns, one
    .npy file per chunk, each atomically renamed into place; metadata.json
    last. reference: checkpoint/save_state_dict.py:145."""
    _count("checkpoint_saves_total")
    _wait_async()   # a running async save commits before its seq is read
    os.makedirs(path, exist_ok=True)
    rank = get_rank()
    seq = _next_save_seq(path)
    meta = {"version": 4, "save_seq": seq, "arrays": {}}
    local = []  # (fname, tensor, bounds)
    for k, v in state_dict.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        blocks = _blocks(t)
        owner = 0   # the process that drives every process id
        meta["arrays"][k] = {
            "shape": list(t.shape), "dtype": _DTYPE_NAMES[t.dtype],
            "chunks": [{"bounds": [list(b) for b in blocks[ck][0]],
                        "file": _chunk_file(seq, owner, k, ck)}
                       for ck in sorted(blocks)]}
        if owner != rank:
            continue
        for ck, (bounds, _) in blocks.items():
            local.append((_chunk_file(seq, rank, k, ck), t, bounds))

    def write_one(fname, t, bounds):
        data = _host_array(t[tuple(slice(a, b) for a, b in bounds)])
        _IO_RETRY.call(_atomic_write_npy, path, fname, data,
                       op="ckpt.chunk_write")
        return fname, _sha256(data)

    def write():
        with _pool() as pool:
            digests = dict(pool.map(lambda a: write_one(*a), local))
        if rank == coordinator_rank:
            for amesh in meta["arrays"].values():
                for chunk in amesh["chunks"]:
                    if chunk["file"] in digests:
                        chunk["sha256"] = digests[chunk["file"]]
            _IO_RETRY.call(_replace_metadata, path, meta,
                           op="ckpt.metadata_replace")
            _gc_stale_chunks(path, meta)

    if async_save:
        # non-daemon: interpreter shutdown joins it, so the checkpoint can
        # never be truncated by process exit
        t = threading.Thread(target=write, daemon=False)
        t.start()
        _async_tasks.append(t)
    else:
        write()


class _ShardFileCache:
    """Memory-maps chunk .npy files on demand: a load touches only the
    chunks overlapping its destination blocks, and nothing is unpickled.
    Each file is verified against its recorded sha256 the first time it
    is opened; missing/truncated/corrupt files raise
    CheckpointCorruptionError with the file name."""

    def __init__(self, path, digests=None):
        self.path = path
        self._digests = digests or {}
        self._files = {}
        self._lock = threading.Lock()

    def get(self, fname):
        if fname not in self._files:
            try:
                arr = np.load(os.path.join(self.path, fname),
                              mmap_mode="r", allow_pickle=False)
            except FileNotFoundError:
                raise CheckpointCorruptionError(
                    fname, "file is missing") from None
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointCorruptionError(
                    fname, f"unreadable ({e})") from None
            expect = self._digests.get(fname)
            if expect is not None:
                try:
                    got = _sha256(arr)
                except (OSError, ValueError) as e:   # mmap read of a
                    raise CheckpointCorruptionError(  # truncated tail
                        fname, f"short read ({e})") from None
                if got != expect:
                    raise CheckpointCorruptionError(
                        fname, f"sha256 mismatch (recorded {expect[:12]}…, "
                        f"found {got[:12]}…)")
            with self._lock:
                self._files[fname] = arr
                last_load_stats["files"] += 1
                last_load_stats["bytes"] += int(arr.nbytes)
        return self._files[fname]


def _torch_from(arr):
    """A read-only view of a memory-mapped chunk as a tensor (only read:
    torch's warning about non-writable arrays is silenced)."""
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        if arr.dtype.kind == "V":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)


def _overlaps(chunk_bounds, bounds):
    return all(max(a0, b0) < min(a1, b1)
               for (a0, a1), (b0, b1) in zip(chunk_bounds, bounds))


def _assemble_region(key, amesh, cache, bounds):
    """The [start:stop)-region of array `key` from the overlapping chunks,
    as a CPU tensor of the saved dtype."""
    shape = tuple(b - a for a, b in bounds)
    out = torch.empty(shape, dtype=_TORCH_DTYPES[amesh["dtype"]])
    filled = 0
    for chunk in amesh["chunks"]:
        cb = [tuple(x) for x in chunk["bounds"]]
        if not _overlaps(cb, bounds):
            continue
        inter = [(max(a0, b0), min(a1, b1))
                 for (a0, a1), (b0, b1) in zip(cb, bounds)]
        data = cache.get(chunk["file"])
        src = tuple(slice(a - c0, b - c0)
                    for (a, b), (c0, _) in zip(inter, cb))
        dst = tuple(slice(a - r0, b - r0)
                    for (a, b), (r0, _) in zip(inter, bounds))
        out[dst] = _torch_from(data[src])
        filled += int(np.prod([b - a for a, b in inter]))
    if filled < int(np.prod(shape)):
        raise ValueError(
            f"checkpoint for '{key}' does not cover region {bounds} "
            f"(filled {filled} of {int(np.prod(shape))} elements)")
    return out


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, offload=False):
    """Fill `state_dict`'s tensors in place, each distinct block of its
    current chunk map (its placements may come from another mesh than the
    one that saved) assembled from the overlapping saved chunks and copied
    to the tensor's device in its dtype; a non-tensor entry is replaced by
    a CPU tensor. reference: checkpoint/load_state_dict.py."""
    _count("checkpoint_loads_total")  # the resume path of elastic recovery
    _wait_async()
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    version = meta.get("version")
    if version not in (3, 4):
        raise ValueError(
            f"checkpoint at {path} has format version {version}; this "
            "loader reads versions 3/4 (per-chunk .npy files). Re-save the "
            "checkpoint with the current save_state_dict.")
    digests = {chunk["file"]: chunk["sha256"]
               for amesh in meta["arrays"].values()
               for chunk in amesh["chunks"] if "sha256" in chunk}
    cache = _ShardFileCache(path, digests)
    last_load_stats.update(files=0, bytes=0)
    plan = []   # (key, saved layout, destination blocks)
    for k, v in state_dict.items():
        if k not in meta["arrays"]:
            raise KeyError(f"checkpoint missing key {k}")
        amesh = meta["arrays"][k]
        shape = tuple(amesh["shape"])
        if isinstance(v, torch.Tensor) and tuple(v.shape) != shape:
            raise ValueError(
                f"shape mismatch for '{k}': checkpoint {shape} vs "
                f"model {tuple(v.shape)}")
        blocks = [b for b, _ in _blocks(v).values()] \
            if isinstance(v, torch.Tensor) else [tuple((0, s) for s in shape)]
        plan.append((k, amesh, blocks))
    # open and verify every overlapping chunk first, in parallel
    with _pool() as pool:
        list(pool.map(cache.get, sorted({
            c["file"] for _, amesh, blocks in plan for c in amesh["chunks"]
            for bounds in blocks if _overlaps(c["bounds"], bounds)})))
    for k, amesh, blocks in plan:
        v = state_dict[k]
        if not isinstance(v, torch.Tensor):
            state_dict[k] = _assemble_region(k, amesh, cache, blocks[0])
            continue
        with torch.no_grad():
            for bounds in blocks:
                block = _assemble_region(k, amesh, cache, bounds)
                v[tuple(slice(a, b) for a, b in bounds)].copy_(
                    block.to(device=v.device, dtype=v.dtype))
    return state_dict
