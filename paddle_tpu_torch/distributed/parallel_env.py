"""Process bootstrap and groups. reference: paddle_tpu/distributed/
parallel_env.py (after python/paddle/distributed/parallel.py:978
init_parallel_env, collective.py:151, the TCPStore rendezvous of
parallel.py:1134).

`init_parallel_env` rendezvouses from the launcher's environment
(`PADDLE_MASTER` host:port, `PADDLE_TRAINERS_NUM`, `PADDLE_TRAINER_ID`)
into `torch.distributed` at tcp://PADDLE_MASTER, with the backend the
launcher's `--backend` set (`PADDLE_DISTRI_BACKEND`: nccl, the default, or
gloo), and opens the port's TCPStore on the master port + 1 for
out-of-band coordination (rank 0 serves it). NCCL takes one rank per
card: asking for it with more ranks than this host's cards raises; it
never switches to gloo quietly. A single process records state only, as
in the reference.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as tdist

_initialized = False
_groups: dict = {}
_next_group_id = 0
_store = None
_backend = None


class Group:
    def __init__(self, ranks, gid, backend=None):
        self.ranks = list(ranks)
        self.id = gid
        self.backend = backend

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return len(self.ranks)

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def process_group(self):
        return self

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


def _check_backend(backend, nproc):
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the port's backends are "
                         "gloo and nccl")
    if backend == "nccl":
        local = int(os.environ.get("PADDLE_LOCAL_SIZE", nproc))
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(
                f"NCCL takes one rank per card: {local} ranks on this host "
                f"and {cards} CUDA device(s); launch with --backend gloo to "
                "share a card")


def init_parallel_env():
    """Join the process group the launcher describes (see the module
    docstring); a single process only records state."""
    global _initialized, _store, _backend
    if _initialized:
        return ParallelEnv()
    master = os.environ.get("PADDLE_MASTER")
    nproc = int(os.environ.get("PADDLE_TRAINERS_NUM", "0") or 0)
    if master and nproc > 1:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        backend = os.environ.get("PADDLE_DISTRI_BACKEND", "nccl")
        _check_backend(backend, nproc)
        if backend == "nccl":
            torch.cuda.set_device(ParallelEnv().device_id)
        tdist.init_process_group(backend, init_method=f"tcp://{master}",
                                 world_size=nproc, rank=rank)
        _backend = backend
        from .store import TCPStore
        host, port = master.rsplit(":", 1)
        _store = TCPStore(host, int(port) + 1, is_master=(rank == 0),
                          world_size=nproc, timeout=300)
    _initialized = True
    _groups[0] = Group(list(range(get_world_size())), 0, _backend)
    return ParallelEnv()


def get_store():
    """The out-of-band TCPStore (None in a single process)."""
    return _store


def get_backend():
    """The process group's backend ("gloo" or "nccl"), None in a single
    process."""
    return _backend


def is_initialized():
    return _initialized


def _multiprocess():
    return tdist.is_available() and tdist.is_initialized()


def get_rank(group=None):
    rank = tdist.get_rank() if _multiprocess() else 0
    if group is not None:
        return group.get_group_rank(rank)
    return rank


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return tdist.get_world_size() if _multiprocess() else 1


def get_group(gid=0):
    return _groups.get(gid)


def new_group(ranks=None, backend=None, timeout=None):
    global _next_group_id
    _next_group_id += 1
    g = Group(ranks if ranks is not None else list(range(get_world_size())),
              _next_group_id, backend or _backend)
    _groups[g.id] = g
    return g


def barrier(group=None):
    """Every rank arrives before any leaves (nothing to wait for in a
    single process)."""
    if _multiprocess():
        tdist.barrier()


def destroy_process_group(group=None):
    """Forget one group, or with none tear down the process group and
    close the store."""
    global _initialized, _store, _backend
    if group is not None:
        _groups.pop(group.id, None)
        return
    _groups.clear()
    if _multiprocess():
        tdist.destroy_process_group()
    if _store is not None:
        _store.close()
        _store = None
    _backend = None
    _initialized = False


class ParallelEnv:
    """The launcher's view of this process."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        """This rank's card: its local rank, modulo the cards present (0
        when ranks share one card)."""
        local = int(os.environ.get("PADDLE_LOCAL_RANK", "0"))
        return local % max(torch.cuda.device_count(), 1)

    @property
    def dev_id(self):
        return self.device_id

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:6170")
        return eps.split(",")

    @property
    def nrings(self):
        return 1
