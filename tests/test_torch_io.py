"""The port's io (datasets, samplers, collate, DataLoader) against the JAX
package's.

- Seeded from numpy's global RNG, every sampler (RandomSampler with and
  without replacement, SubsetRandomSampler, WeightedRandomSampler, a
  shuffling BatchSampler, DistributedBatchSampler per rank) and
  random_split give the reference's index sequences, so a seeded shuffle
  gives the same batches in both packages.
- The threaded loader (num_workers > 0) yields the unthreaded loader's
  batches in order, which equal the reference's; a worker's exception is
  raised again in the consumer; no more than num_workers *
  prefetch_factor batches are fetched ahead of the consumer; under more
  workers than cores and a short switch interval every batch arrives
  once, in order.
- default_collate_fn over nested dicts, tuples, strings, ints, floats,
  arrays and tensors gives the reference's structure and values; large
  batches go through the native collate (csrc/collate.cc), equal to
  np.stack.
- The dataset wrappers index as the reference's.
Everything here is exact: indices and host arrays.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.io import _collate


def _squares(io, n=23, shape=(3,)):
    """A map-style dataset of (array, label) pairs on `io`'s Dataset."""

    class Squares(io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return np.full(shape, i * i, np.float32), i % 5

    return Squares()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return x


def _as_lists(batches):
    return [[_np(t) for t in b] for b in batches]


def _seeded(fn, seed=3):
    np.random.seed(seed)
    return fn()


SAMPLERS = {
    "random": lambda io, ds: list(io.RandomSampler(ds)),
    "random_replacement": lambda io, ds: list(io.RandomSampler(
        ds, replacement=True, num_samples=40)),
    "subset_random": lambda io, ds: list(io.SubsetRandomSampler(
        [4, 9, 2, 7, 11])),
    "weighted": lambda io, ds: list(io.WeightedRandomSampler(
        [0.1, 0.5, 0.2, 0.2], 12)),
    "batch_shuffle": lambda io, ds: list(io.BatchSampler(
        ds, shuffle=True, batch_size=4, drop_last=True)),
    "distributed_rank1": lambda io, ds: list(io.DistributedBatchSampler(
        ds, 3, num_replicas=2, rank=1, shuffle=True)),
    "random_split": lambda io, ds: [s.indices for s in io.random_split(
        ds, [10, 13])],
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_seeded_samplers_match_reference(name):
    want = _seeded(lambda: SAMPLERS[name](jio, _squares(jio)))
    got = _seeded(lambda: SAMPLERS[name](pio, _squares(pio)))
    assert got == want
    assert _seeded(lambda: SAMPLERS[name](pio, _squares(pio))) == got


@pytest.mark.parametrize("workers", [0, 3])
def test_seeded_shuffled_loader_matches_reference(workers):
    want = _seeded(lambda: _as_lists(jio.DataLoader(
        _squares(jio), batch_size=4, shuffle=True)))
    got = _seeded(lambda: _as_lists(pio.DataLoader(
        _squares(pio), batch_size=4, shuffle=True,
        num_workers=workers)))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_threaded_and_plain_loaders_yield_equal_batches():
    ds = _squares(pio, n=37)
    plain = _as_lists(pio.DataLoader(ds, batch_size=5, drop_last=True))
    for workers in (1, 2, 7):
        threaded = _as_lists(pio.DataLoader(ds, batch_size=5,
                                            drop_last=True,
                                            num_workers=workers))
        assert len(threaded) == len(plain) == 7
        for g, w in zip(threaded, plain):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert len(pio.DataLoader(ds, batch_size=5)) == 8


class _Boom(Exception):
    pass


def test_a_worker_exception_is_raised_in_the_consumer():
    class Bad(pio.Dataset):
        def __len__(self):
            return 12

        def __getitem__(self, i):
            if i == 7:
                raise _Boom(f"item {i}")
            return np.zeros(2, np.float32)

    loader = pio.DataLoader(Bad(), batch_size=2, num_workers=3)
    got = []
    with pytest.raises(_Boom, match="item 7"):
        for b in loader:
            got.append(b)
    assert len(got) == 3          # the batches before the failing one


def test_prefetch_window_bounds_the_fetches_ahead():
    workers, factor = 2, 2
    lock = threading.Lock()
    fetched = [0]

    def collate(items):
        with lock:
            fetched[0] += 1
        return pio.default_collate_fn(items)

    loader = pio.DataLoader(_squares(pio, n=40), batch_size=2,
                            num_workers=workers, prefetch_factor=factor,
                            collate_fn=collate)
    ahead = []
    for consumed, _ in enumerate(loader, 1):
        time.sleep(0.01)       # a slow consumer: the workers run ahead
        with lock:
            ahead.append(fetched[0] - consumed)
    assert consumed == 20 and fetched[0] == 20
    assert max(ahead) <= workers * factor
    assert max(ahead) >= 1       # they did run ahead


def test_many_workers_deliver_every_batch_in_order():
    old, threads = sys.getswitchinterval(), threading.active_count()
    sys.setswitchinterval(1e-5)
    try:
        ds = _squares(pio, n=200)
        t0 = time.monotonic()
        labels = [b[1].tolist() for b in pio.DataLoader(
            ds, batch_size=3, num_workers=32, prefetch_factor=1)]
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert sum(labels, []) == [i % 5 for i in range(200)]
    assert threading.active_count() == threads   # the workers were joined


def _structure(x):
    """(type tag, values) of a collated batch, for either package."""
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return ("seq", [_structure(v) for v in x])
    if isinstance(x, (str, bytes)):
        return x
    a = _np(x)
    kind = "float" if a.dtype.kind == "f" else "int"
    return (kind, a.shape, a.astype(np.float64).tolist())


def test_nested_collate_matches_reference():
    batch = [{"img": np.full((2, 2), i, np.float32), "id": i,
              "score": 0.5 * i, "tag": f"s{i}",
              "pair": (np.arange(3) + i, [float(i), 1.0])}
             for i in range(4)]
    want = _structure(jio.default_collate_fn(batch))
    got = pio.default_collate_fn(batch)
    assert _structure(got) == want
    assert got["img"].dtype == torch.float32 and got["id"].dtype == \
        torch.int64 and got["score"].dtype == torch.float32
    t = pio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert t.shape == (2, 2)


def test_large_batches_use_the_native_collate():
    arrays = [np.random.RandomState(i).rand(64, 64, 3).astype(np.float32)
              for i in range(8)]
    assert _collate.available()
    np.testing.assert_array_equal(_collate.collate_stack(arrays),
                                  np.stack(arrays))
    got = pio.default_collate_fn(arrays)
    np.testing.assert_array_equal(got.numpy(), np.stack(arrays))
    mixed = [np.zeros(3, np.float32), np.zeros(3, np.float64)]
    assert _collate.collate_stack(mixed).dtype == np.float64


def test_dataset_wrappers_index_as_the_reference():
    for io in (jio, pio):
        ds = _squares(io, n=6)
        td = io.TensorDataset([np.arange(6), np.arange(6) * 2])
        assert [int(v) for v in td[4]] == [4, 8] and len(td) == 6
        comp = io.ComposeDataset([ds, td])
        assert len(comp) == 6 and len(comp[2]) == 4
        cat = io.ConcatDataset([ds, _squares(io, n=4)])
        assert len(cat) == 10 and cat[7][1] == 1 and cat[-1][1] == 3
        sub = io.Subset(ds, [5, 1])
        assert sub[0][1] == 0 and len(sub) == 2

        class It(io.IterableDataset):
            def __iter__(self):
                return iter(range(7))

        chained = [v for v in io.ChainDataset([It(), It()])]
        assert len(chained) == 14
        batches = [_np(b).tolist() for b in io.DataLoader(
            It(), batch_size=3, drop_last=True)]
        assert batches == [[0, 1, 2], [3, 4, 5]]
        assert io.get_worker_info() is None
