"""Semi-auto parallel (DTensor-style) API. reference: paddle_tpu/
distributed/api.py (:33-229).

A "DistTensor" here is a torch tensor that holds its global value on its
own device and carries `process_mesh` and `placements` (placement.py);
`chunk_map(t.process_mesh, t.placements, t.shape)` says which block each
process id owns. Every function keeps the reference's values: reshard
changes the marks and never the value (Partial -> Replicate is the
identity, as the reference's global-view p->r is).
"""

from __future__ import annotations

import torch

from .placement import (Partial, ProcessMesh, Replicate, Shard,  # noqa: F401
                        chunk_map)

__all__ = ["shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
           "shard_optimizer", "unshard_dtensor", "dtensor_from_local",
           "shard_dataloader", "to_distributed"]


def _attach_dist(t, mesh, placements):
    t.process_mesh = mesh
    t.placements = list(placements)
    return t


def _on_mesh(t, mesh):
    """t on the mesh's device unless it already lies on one of its
    process ids' devices."""
    if t.device in {mesh.device_of(i) for i in mesh.process_ids}:
        return t
    return t.to(mesh.device)


def _legacy_placements(legacy):
    mesh = legacy.process_mesh
    dim_names = list(getattr(mesh, "dim_names", []))
    placements = [Replicate() for _ in dim_names]
    for axis, spec in enumerate(legacy.sharding_specs):
        if spec is not None:
            placements[dim_names.index(spec)] = Shard(axis)
    return mesh, placements


def shard_tensor(data, mesh=None, placements=None, dtype=None, place=None,
                 stop_gradient=None, dist_attr=None):
    """reference: api.py:33. Accepts the placements form (mesh,
    [Shard/Replicate/Partial...]) or the legacy DistAttr form (mesh and
    per-tensor-axis sharding_specs). A Parameter is marked in place (and
    moved onto the mesh's device if it lies elsewhere); any other input
    gives a new tensor sharing its value."""
    legacy = dist_attr if dist_attr is not None else (
        mesh if hasattr(mesh, "sharding_specs") else None)
    if legacy is not None:
        mesh, placements = _legacy_placements(legacy)
    if isinstance(data, torch.Tensor):
        t = data if dtype is None else data.to(_dtype(dtype))
    else:
        t = torch.as_tensor(data, dtype=_dtype(dtype) if dtype else None)
    chunk_map(mesh, placements, t.shape)        # raises where it must
    moved = _on_mesh(t, mesh)
    if isinstance(data, torch.nn.Parameter):
        out = data
        if moved is not data:
            out.data = moved.detach()
    else:
        out = moved.detach()
        out.requires_grad_(t.requires_grad)
    if stop_gradient is not None:
        out.requires_grad_(not stop_gradient)
    return _attach_dist(out, mesh, placements)


def _dtype(dtype):
    from ..framework.dtypes import convert_dtype
    return convert_dtype(dtype)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def dtensor_from_local(local_tensor, mesh, placements):
    """reference: api.py:64. In the global view the local tensor is the
    global value."""
    return shard_tensor(local_tensor, mesh, placements)


def reshard(dist_tensor, mesh, placements):
    """reference: api.py:77-99. The same value under new marks, as a new
    tensor that autograd passes through (moved if `mesh` lies on another
    device)."""
    chunk_map(mesh, placements, dist_tensor.shape)
    out = _on_mesh(dist_tensor, mesh)
    if out is dist_tensor:
        out = dist_tensor.view_as(dist_tensor)
    return _attach_dist(out, mesh, placements)


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """reference: api.py:107 — apply shard_fn(name, layer, mesh) to every
    sublayer; the default replicates parameters over the mesh."""

    def default_shard_fn(name, sublayer, mesh):
        for _, p in sublayer.named_parameters(recurse=False):
            shard_tensor(p, mesh, [Replicate() for _ in range(mesh.ndim)])

    fn = shard_fn or default_shard_fn
    for name, sub in layer.named_sublayers(include_self=True):
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda l, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


class _ShardOptimizer:
    """reference: api.py:133. Wraps an optimizer so that after each step
    every state tensor is passed through shard_fn(name, param, state)."""

    def __init__(self, optimizer, shard_fn=None):
        self._inner = optimizer
        self._shard_fn = shard_fn

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def step(self):
        self._inner.step()
        if self._shard_fn is not None:
            for p in self._inner._parameter_list:
                st = self._inner._accumulators.get(id(p))
                if st:
                    for k, v in st.items():
                        if isinstance(v, torch.Tensor):
                            st[k] = self._shard_fn(k, p, v)

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)


def shard_optimizer(optimizer, shard_fn=None):
    return _ShardOptimizer(optimizer, shard_fn)


def unshard_dtensor(dist_tensor):
    """reference: api.py:164 — the global value as a plain tensor."""
    mesh = getattr(dist_tensor, "process_mesh", None)
    if mesh is None:
        return dist_tensor
    out = dist_tensor.detach()
    out.requires_grad_(dist_tensor.requires_grad)
    return out


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _ShardDataLoader:
    def __init__(self, dataloader, meshes, shard_dims=None):
        self._dl = dataloader
        self._meshes = meshes if isinstance(meshes, (list, tuple)) \
            else [meshes]
        self._shard_dims = shard_dims

    def __iter__(self):
        mesh = self._meshes[0]
        dim = self._shard_dims
        if isinstance(dim, str):
            axis = mesh.dim_names.index(dim)
        else:
            axis = dim if dim is not None else None
        for batch in self._dl:
            if axis is None:
                yield batch
                continue
            placements = [Shard(0) if i == axis else Replicate()
                          for i in range(mesh.ndim)]
            yield _tree_map(lambda t: shard_tensor(t, mesh, placements)
                            if isinstance(t, torch.Tensor) else t, batch)

    def __len__(self):
        return len(self._dl)


def shard_dataloader(dataloader, meshes, shard_dims=None,
                     is_dataset_splitted=False):
    """reference: api.py:204."""
    return _ShardDataLoader(dataloader, meshes, shard_dims)


def to_distributed(model, optimizer=None, dataloader=None, device_num=None,
                   node_num=1, config=None):
    """One-call auto-parallel entry (reference: api.py:209): a 1-axis 'dp'
    ProcessMesh of `device_num` process ids (the CUDA device count if
    None), every parameter and buffer marked replicated on it, and each
    batch's leading dim sharded over 'dp'. The mesh lies on the model's
    device. Returns (model, optimizer, dataloader)."""
    n = device_num or torch.cuda.device_count()
    if not n:
        raise RuntimeError(
            "to_distributed: no CUDA device to count; pass device_num")
    first = next(iter(model.parameters()), None)
    device = first.device if first is not None else None
    mesh = ProcessMesh(shape=[int(n)], dim_names=["dp"], device=device)
    replicated = [Replicate()]
    for _, p in model.named_parameters():
        shard_tensor(p, mesh, replicated)
    for _, buf in model.named_buffers():
        _attach_dist(buf, mesh, replicated)
    if dataloader is not None:
        dataloader = shard_dataloader(dataloader, mesh, shard_dims="dp")
    return model, optimizer, dataloader
