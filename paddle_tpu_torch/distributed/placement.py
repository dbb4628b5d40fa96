"""DTensor placements and ProcessMesh. reference: paddle_tpu/distributed/
placement.py (`Placement`, `Shard`, `Replicate`, `Partial` :26-83,
`ProcessMesh` :86-164, `build_mesh`, `to_partition_spec` :167-195).

The reference's mesh is a `jax.sharding.Mesh` and a "DistTensor" a
jax.Array whose `NamedSharding` places one block on each device. The port
keeps the reference's global view: a tensor holds its whole (global) value
on its own device and carries its mesh and placements as marks
(`process_mesh`, `placements`). Which block each process id owns is the
chunk map (`chunk_map`), the same map `NamedSharding.devices_indices_map`
gives for the same mesh and placements; checkpoints, ZeRO and the local
queries read it. A mesh of N process ids may lie on fewer cards: process
id i maps to `cuda:(i % device_count)`, or to the CPU when the mesh is
built with device="cpu". Real placement of blocks on several cards is
ROADMAP Queue 1's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.device import resolve_device

__all__ = ["Placement", "Shard", "Replicate", "Partial", "ProcessMesh",
           "to_partition_spec", "build_mesh"]

_default_mesh = [None]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return isinstance(other, Partial) and other.reduce_type == \
            self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))


class ProcessMesh:
    """An n-d array of process ids with a name per axis. `device` (the
    port's default device if None) is where its tensors live: on CUDA,
    process id i is `cuda:(i % device_count)`."""

    def __init__(self, mesh=None, dim_names=None, shape=None, *,
                 device=None):
        if mesh is None and shape is not None:
            arr = np.arange(int(np.prod(shape))).reshape(shape)
        else:
            arr = np.asarray(mesh)
        self._ids = np.asarray(arr, dtype=np.int64)
        self._shape = tuple(self._ids.shape)
        self._dim_names = list(dim_names) if dim_names else [
            f"d{i}" for i in range(self._ids.ndim)]
        self._device = resolve_device(device)

    @property
    def mesh(self):
        """The process ids as an array of the mesh's shape."""
        return self._ids

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return [int(i) for i in self._ids.reshape(-1)]

    @property
    def device(self):
        """The device of the mesh's first process id."""
        return self.device_of(self.process_ids[0])

    def device_of(self, process_id):
        if self._device.type != "cuda":
            return self._device
        return torch.device("cuda", int(process_id)
                            % max(torch.cuda.device_count(), 1))

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def get_mesh_with_dim(self, name, index=None):
        i = self._dim_names.index(name)
        if index is None:
            # reorder with `name` first
            order = [i] + [j for j in range(self.ndim) if j != i]
            return ProcessMesh(np.transpose(self._ids, order),
                               [self._dim_names[j] for j in order],
                               device=self._device)
        return ProcessMesh(np.take(self._ids, index, axis=i),
                           [n for j, n in enumerate(self._dim_names)
                            if j != i], device=self._device)

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and self._shape == other._shape
                and self._dim_names == other._dim_names)

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names})"

    def __enter__(self):
        _default_mesh[0] = self
        return self

    def __exit__(self, *exc):
        _default_mesh[0] = None
        return False


def build_mesh(shape, dim_names, *, device=None):
    return ProcessMesh(shape=shape, dim_names=dim_names, device=device)


def to_partition_spec(placements, ndim=None):
    """Invert per-mesh-axis placements into a per-tensor-dim spec.

    placements[i] describes mesh axis i (paddle convention). A tensor dim may
    be sharded over multiple mesh axes (they stack in order)."""
    dim_to_axes: dict[int, list] = {}
    for axis_idx, p in enumerate(placements):
        if isinstance(p, Shard):
            dim_to_axes.setdefault(p.dim, []).append(axis_idx)
    max_dim = (max(dim_to_axes) + 1) if dim_to_axes else 0
    n = ndim if ndim is not None else max_dim
    spec = []
    for d in range(n):
        axes = dim_to_axes.get(d)
        if not axes:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(tuple(axes))
    return spec


class PartitionSpec(tuple):
    """A per-tensor-dim spec of mesh axis names: None (replicated), a
    name, or a tuple of names stacked major first. The port's copy of
    jax.sharding.PartitionSpec, for the sharding rules."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_to_placements(spec, mesh, ndim=None):
    """A PartitionSpec of axis names as per-mesh-axis placements: the
    inversion of `to_partition_spec`. Axes stack in the mesh's order, so
    a dim sharded over several axes must name them in that order."""
    names = mesh.dim_names
    placements = [Replicate() for _ in names]
    parts = list(spec) + [None] * max(0, (ndim or 0) - len(spec))
    for dim, entry in enumerate(parts):
        axes = [names.index(a) for a in _axes(entry)]
        if axes != sorted(axes):
            raise ValueError(
                f"dim {dim} of spec {tuple(spec)} names mesh axes out of "
                f"the mesh's order {names}")
        for a in axes:
            if placements[a].is_shard():
                raise ValueError(f"mesh axis {names[a]!r} shards two dims")
            placements[a] = Shard(dim)
    return placements


def chunk_map(mesh, placements, shape):
    """{process id: tuple of slices}: the block of a global tensor of
    `shape` that each process id of `mesh` owns under `placements`, as
    `NamedSharding.devices_indices_map` gives it (a dim cut in one piece
    is slice(None)). Partial owns the whole value, as Replicate. Raises
    ValueError where a sharded dim does not divide."""
    shape = tuple(int(s) for s in shape)
    spec = to_partition_spec(placements, len(shape))
    if len(spec) > len(shape):
        raise ValueError(f"placements {placements} shard dim "
                         f"{len(spec) - 1} of a {len(shape)}-d tensor")
    sizes = mesh.shape
    cuts = []
    for dim, s in enumerate(spec):
        axes = _axes(s)
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if shape[dim] % n:
            raise ValueError(
                f"dim {dim} of shape {shape} does not divide into {n} "
                f"pieces over mesh axes "
                f"{[mesh.dim_names[a] for a in axes]}")
        cuts.append((axes, n, shape[dim] // n))
    out = {}
    for coord in np.ndindex(*sizes):
        index = []
        for axes, n, size in cuts:
            if n == 1:
                index.append(slice(None))
                continue
            k = 0
            for a in axes:
                k = k * sizes[a] + coord[a]
            index.append(slice(k * size, (k + 1) * size))
        out[int(mesh.mesh[coord])] = tuple(index)
    return out
