"""Data loading. reference: paddle_tpu/io/__init__.py (:30-439;
python/paddle/io/: reader.py:262 DataLoader, io/dataloader/ dataset.py,
sampler.py, worker.py, collate.py).

The samplers draw from numpy's global RNG, as the reference's do, so a
seeded `shuffle` gives the same batches in both packages. Batches are
collated on the host into CPU tensors (numpy arrays by `torch.from_numpy`;
large ones stacked by the native collate, io/_collate.py) and stay there:
`hapi.Model` moves them to the network's device. With `num_workers` > 0
a pool of threads fetches batches within a bounded prefetch window, and a
worker's exception is raised again in the consumer.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading

import numpy as np
import torch

from . import _collate

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "ConcatDataset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "SubsetRandomSampler", "DataLoader",
           "get_worker_info", "default_collate_fn"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors)
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumsum = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cumsum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        for i, c in enumerate(self.cumsum):
            if idx < c:
                prev = self.cumsum[i - 1] if i > 0 else 0
                return self.datasets[i][idx - prev]
        raise IndexError


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * l)) for l in lengths]
        lengths[0] += n - sum(lengths)
    total = sum(lengths)
    perm = np.random.permutation(total)
    out = []
    offset = 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out


# ---------------------------------------------------------------------------
# samplers (reference: python/paddle/io/dataloader/sampler.py,
# batch_sampler.py)
# ---------------------------------------------------------------------------


def _world():
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        self.indices = list(indices)

    def __iter__(self):
        order = np.random.permutation(len(self.indices))
        return iter(self.indices[i] for i in order)

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the index space across data-parallel ranks (those of
    torch.distributed's default group unless given). reference:
    python/paddle/io/dataloader/batch_sampler.py:DistributedBatchSampler."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        world, me = _world()
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ---------------------------------------------------------------------------
# collate + loader (reference: python/paddle/io/dataloader/collate.py,
# worker.py)
# ---------------------------------------------------------------------------


def _np_stack(arrays):
    """Stack via the native parallel collate (C++ memcpy with the
    interpreter lock released) when the batch is big enough to benefit
    (8 samples of 64 KiB or more); reference hot path:
    paddle/fluid/framework/data_feed.cc."""
    if len(arrays) >= 8 and getattr(arrays[0], "nbytes", 0) >= (1 << 16) \
            and _collate.available():
        return _collate.collate_stack(arrays)
    return np.stack(arrays)


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(_np_stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items)) for items in zip(*batch))
    raise TypeError(f"cannot collate {type(sample)}")


class _WorkerInfo:
    def __init__(self, id_, num_workers, dataset):
        self.id = id_
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info


class DataLoader:
    """reference: python/paddle/io/reader.py:262. Thread-pool workers and a
    bounded prefetch window; batches stay on the host."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = prefetch_factor
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                                  batch_size=batch_size,
                                                  drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _fetch(self, indices):
        items = [self.dataset[i] for i in indices]
        return self.collate_fn(items)

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        yield from self._iter_threaded()

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_threaded(self):
        """Thread-pool fetch with a bounded in-flight window: at most
        num_workers * prefetch_factor batches are fetched ahead of the
        consumer (the prefetch_factor contract of
        io/dataloader/dataloader_iter.py); without the bound, workers race
        arbitrarily far ahead and buffer the whole epoch in memory."""
        idx_queue: queue.Queue = queue.Queue()
        out: dict[int, object] = {}
        done = threading.Event()
        lock = threading.Lock()
        cond = threading.Condition(lock)
        window = threading.Semaphore(
            max(self.num_workers * max(self.prefetch_factor, 1), 1))
        batches = list(self.batch_sampler)
        for i, b in enumerate(batches):
            idx_queue.put((i, b))

        def worker():
            while not done.is_set():
                # bounded wait so shutdown can't strand a worker in acquire
                if not window.acquire(timeout=0.1):
                    continue
                try:
                    i, b = idx_queue.get_nowait()
                except queue.Empty:
                    window.release()
                    return
                try:
                    data = self._fetch(b)
                except Exception as e:  # raised again in the consumer
                    data = _WorkerError(e)
                with cond:
                    out[i] = data
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with cond:
                    while i not in out:
                        cond.wait(timeout=60)
                    data = out.pop(i)
                window.release()  # consumed: admit the next fetch
                if isinstance(data, _WorkerError):
                    raise data.exc  # same behavior as num_workers=0
                yield data
        finally:
            done.set()
            for t in threads:   # each ends within its fetch and 0.1 s
                t.join()


class _WorkerError:
    """Exception captured in a loader worker, re-raised by the consumer."""

    def __init__(self, exc):
        self.exc = exc
