"""Slot-based datasets for PS-mode (recsys) training. reference:
paddle_tpu/distributed/dataset.py (`_parse_line` :45, `_batches` :92,
`InMemoryDataset` :108, `QueueDataset` :203, `MultiSlotDataGenerator`
:244), after python/paddle/distributed/fleet/dataset/dataset.py and
fleet/data_generator.

The parser runs on the host over numpy, with an optional pipe_command run
as a subprocess a file. The multislot text format is the reference's
verbatim (per line, per slot in use_var order: `<n> <v_1> ... <v_n>`), as
is its LoD contract: each slot yields (flat values, offsets) a batch, and
offsets[i]:offsets[i+1] are instance i's values.
"""

from __future__ import annotations

import shlex
import subprocess
import threading

import numpy as np

__all__ = ["InMemoryDataset", "QueueDataset", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class _SlotVar:
    """use_var entry: name + dtype ('int64' sparse feasigns or 'float32'
    dense values). Accepts plain strings (int64 slots) or objects with
    .name/.dtype (static.data Variables)."""

    def __init__(self, v):
        if isinstance(v, str):
            self.name, self.dtype = v, "int64"
        else:
            self.name = getattr(v, "name", str(v))
            dt = str(getattr(v, "dtype", "int64")).lower()
            self.dtype = "float32" if "float" in dt else "int64"


def _parse_line(line, slots):
    """One multislot line -> [(values ndarray)] in slot order, or None for
    malformed lines (the reference data feed skips them)."""
    toks = line.split()
    out = []
    i = 0
    try:
        for sv in slots:
            n = int(toks[i])
            i += 1
            vals = toks[i:i + n]
            if len(vals) != n:
                return None
            i += n
            if sv.dtype == "int64":
                out.append(np.array([int(x) for x in vals], np.int64))
            else:
                out.append(np.array([float(x) for x in vals], np.float32))
    except (ValueError, IndexError):
        return None
    if i != len(toks):
        # leftover tokens = slot-count mismatch between use_var and the
        # file; accepting the prefix would train on misaligned features
        return None
    return out


def _read_file_lines(path, pipe_command):
    if pipe_command in (None, "", "cat"):
        with open(path, "r") as f:
            yield from f
        return
    with open(path, "rb") as f:
        proc = subprocess.Popen(shlex.split(pipe_command), stdin=f,
                                stdout=subprocess.PIPE, text=True)
        assert proc.stdout is not None
        try:
            yield from proc.stdout
        finally:
            proc.stdout.close()
            rc = proc.wait()
        if rc != 0:
            # a crashed preprocessor must not silently truncate the data
            raise RuntimeError(
                f"pipe_command {pipe_command!r} exited {rc} on {path}")


def _batches(records, batch_size, slots):
    """Group parsed records into LoD batches:
    {name: (flat_values, offsets)} per batch."""
    for start in range(0, len(records), batch_size):
        chunk = records[start:start + batch_size]
        batch = {}
        for si, sv in enumerate(slots):
            parts = [r[si] for r in chunk]
            offsets = np.zeros(len(parts) + 1, np.int64)
            np.cumsum([p.size for p in parts], out=offsets[1:])
            flat = np.concatenate(parts) if parts else \
                np.zeros(0, np.int64 if sv.dtype == "int64" else np.float32)
            batch[sv.name] = (flat, offsets)
        yield batch


class InMemoryDataset:
    """reference: fleet/dataset/dataset.py InMemoryDataset — load files into
    RAM, shuffle, iterate LoD batches. Single-controller: global_shuffle
    degrades to local_shuffle (there is no trainer fleet to exchange with;
    each host shuffles its own shard of the filelist)."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.pipe_command = "cat"
        self.slots: list[_SlotVar] = []
        self.filelist: list[str] = []
        self._records: list = []
        self._rng = np.random.RandomState(0)
        self._preload_thread = None

    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command="cat", input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", **kwargs):
        self.batch_size = int(batch_size)
        self.thread_num = int(thread_num)
        self.pipe_command = pipe_command
        if use_var:
            self.set_use_var(use_var)
        return self

    def update_settings(self, **kwargs):
        for k, v in kwargs.items():
            if k == "use_var":
                self.set_use_var(v)
            elif hasattr(self, k):
                setattr(self, k, v)

    def set_use_var(self, var_list):
        self.slots = [_SlotVar(v) for v in var_list]

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    # --- loading ----------------------------------------------------------
    def _load(self):
        records = []
        for path in self.filelist:
            for line in _read_file_lines(path, self.pipe_command):
                line = line.strip()
                if not line:
                    continue
                rec = _parse_line(line, self.slots)
                if rec is not None:
                    records.append(rec)
        return records

    def load_into_memory(self, is_shuffle=False):
        if not self.slots:
            raise RuntimeError("init(use_var=...) before load_into_memory")
        self._records = self._load()
        if is_shuffle:
            self.local_shuffle()

    def preload_into_memory(self, thread_num=None):
        self._preload_thread = threading.Thread(
            target=lambda: setattr(self, "_records", self._load()),
            daemon=True)
        self._preload_thread.start()

    def wait_preload_done(self):
        if self._preload_thread is not None:
            self._preload_thread.join()
            self._preload_thread = None

    def local_shuffle(self):
        self._rng.shuffle(self._records)

    def global_shuffle(self, fleet=None, thread_num=12):
        # single-controller runtime: each host holds its own filelist
        # shard; shuffling it locally is the whole operation
        self.local_shuffle()

    def release_memory(self):
        self._records = []

    def get_memory_data_size(self, fleet=None):
        return len(self._records)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._records)

    # --- iteration --------------------------------------------------------
    def __iter__(self):
        yield from _batches(self._records, self.batch_size, self.slots)

    def __len__(self):
        return (len(self._records) + self.batch_size - 1) // self.batch_size


class QueueDataset(InMemoryDataset):
    """reference: QueueDataset — streaming iteration over the filelist
    without materializing records (no shuffle)."""

    def load_into_memory(self, is_shuffle=False):  # pragma: no cover
        raise RuntimeError("QueueDataset streams; use iteration directly "
                           "(reference: QueueDataset has no memory ops)")

    def preload_into_memory(self, thread_num=None):
        raise RuntimeError("QueueDataset streams; no memory ops")

    def wait_preload_done(self):
        raise RuntimeError("QueueDataset streams; no memory ops")

    def __len__(self):
        raise TypeError("QueueDataset streams; it has no length")

    def local_shuffle(self):
        raise RuntimeError("QueueDataset cannot shuffle (reference parity)")

    def global_shuffle(self, fleet=None, thread_num=12):
        raise RuntimeError("QueueDataset cannot shuffle (reference parity)")

    def __iter__(self):
        pending = []
        for path in self.filelist:
            for line in _read_file_lines(path, self.pipe_command):
                line = line.strip()
                if not line:
                    continue
                rec = _parse_line(line, self.slots)
                if rec is None:
                    continue
                pending.append(rec)
                if len(pending) == self.batch_size:
                    yield from _batches(pending, self.batch_size, self.slots)
                    pending = []
        if pending:
            yield from _batches(pending, self.batch_size, self.slots)


class MultiSlotDataGenerator:
    """reference: fleet/data_generator — user subclasses override
    generate_sample(line) returning an iterator of records
    [(slot_name, [values]), ...]; run_from_* emits the multislot text the
    datasets parse. The pipe protocol is preserved so generators written
    for the reference work unchanged."""

    def __init__(self):
        self._batch = 1

    def set_batch(self, batch_size):
        self._batch = int(batch_size)

    def generate_sample(self, line):  # pragma: no cover - abstract
        raise NotImplementedError(
            "subclass MultiSlotDataGenerator and implement generate_sample")

    def _format(self, record):
        parts = []
        for _name, values in record:
            vs = list(values)
            parts.append(str(len(vs)))
            parts.extend(str(v) for v in vs)
        return " ".join(parts)

    def _records_of(self, line):
        gen = self.generate_sample(line)
        if gen is None:
            return
        if callable(gen):  # reference allows returning a generator FUNC
            gen = gen()
        yield from gen

    def run_from_memory(self, lines=None):
        """Yield formatted multislot lines from in-memory raw lines."""
        out = []
        for line in (lines or [None]):
            for record in self._records_of(line):
                out.append(self._format(record))
        return out

    def run_from_stdin(self):  # pragma: no cover - exercised via pipe tests
        import sys
        for line in sys.stdin:
            for record in self._records_of(line):
                sys.stdout.write(self._format(record) + "\n")


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """String-valued slots flavor (reference keeps values as strings;
    formatting is identical)."""
