"""Tensor-parallel (Megatron-style) layers. reference:
paddle_tpu/distributed/fleet/meta_parallel/parallel_layers.py
(`VocabParallelEmbedding`, `ColumnParallelLinear`, `RowParallelLinear`,
`ParallelCrossEntropy`, `TensorParallel`, `ShardingParallel`,
`SegmentParallel`), after fleet/layers/mpu/mp_layers.py.

Each layer marks its weight with the placements of its Megatron split
over the "mp" axis of the hybrid group's mesh, and `_constrain` marks its
activations the same way: the global value is computed whole, so the
math is the dense layer's and the marks say which block each mp rank
would hold.
"""

from __future__ import annotations

from ....nn import functional as F
from ....nn import initializer as I
from ....nn.layer.layers import Layer
from ...placement import chunk_map, spec_to_placements

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "TensorParallel",
           "ShardingParallel", "SegmentParallel"]


def _mp_mesh():
    from .. import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.mesh


def _device():
    """Where the layers build their parameters: the hybrid group's mesh's
    device, else the port's default."""
    mesh = _mp_mesh()
    return None if mesh is None else mesh.device


def _mark(t, mesh, spec):
    """Mark t with spec's placements on mesh; False (t unmarked) where an
    axis does not divide its dim."""
    placements = spec_to_placements(spec, mesh, t.ndim)
    try:
        chunk_map(mesh, placements, t.shape)
    except ValueError:
        return False
    t.process_mesh = mesh
    t.placements = placements
    return True


def _constrain(x, spec):
    """x as a new tensor (autograd passes through) marked with `spec` over
    the hybrid group's mesh; x itself without a group."""
    mesh = _mp_mesh()
    if mesh is None:
        return x
    out = x.view_as(x)
    _mark(out, mesh, spec)
    return out


def _shard_param(p, spec):
    mesh = _mp_mesh()
    if mesh is not None and p is not None:
        _mark(p, mesh, spec)   # axis size may not divide on tiny shapes
    return p


class VocabParallelEmbedding(Layer):
    """Vocab dim sharded over mp. reference: mp_layers.py:47."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._num = num_embeddings
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.XavierNormal(), device=_device())
        _shard_param(self.weight, ("mp", None))

    def forward(self, x):
        out = F.embedding(x, self.weight)
        return _constrain(out, (None, None, None))


class ColumnParallelLinear(Layer):
    """Weight (in, out) sharded on out over mp. reference: mp_layers.py:334."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.gather_output = gather_output
        self.weight = self.create_parameter((in_features, out_features),
                                            attr=weight_attr,
                                            device=_device())
        self.bias = (self.create_parameter((out_features,), is_bias=True,
                                           device=_device())
                     if has_bias else None)
        _shard_param(self.weight, (None, "mp"))
        if self.bias is not None:
            _shard_param(self.bias, ("mp",))

    def forward(self, x):
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            return _constrain(out, (None,))  # replicated (all-gathered)
        # keep sharded on the feature (last) dim
        return _constrain(out, (None,) * (out.ndim - 1) + ("mp",))


class RowParallelLinear(Layer):
    """Weight (in, out) sharded on in over mp; the partial sums reduced.
    reference: mp_layers.py:541."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter((in_features, out_features),
                                            attr=weight_attr,
                                            device=_device())
        self.bias = (self.create_parameter((out_features,), is_bias=True,
                                           device=_device())
                     if has_bias else None)
        _shard_param(self.weight, ("mp", None))

    def forward(self, x):
        if not self.input_is_parallel:
            x = _constrain(x, (None,) * (x.ndim - 1) + ("mp",))
        out = F.linear(x, self.weight, None)
        out = _constrain(out, (None,))  # the psum of partials
        if self.bias is not None:
            out = out + self.bias
        return out


class ParallelCrossEntropy(Layer):
    """reference: mp_layers.py:742 — the softmax over vocab-sharded
    logits, per position."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index)


class TensorParallel(Layer):
    """reference: fleet/meta_parallel/tensor_parallel.py — one process
    holds the global state, so there is nothing to broadcast."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)


class ShardingParallel(TensorParallel):
    pass


class SegmentParallel(TensorParallel):
    """The 'sep' axis wrapper (sequence split across ranks). reference:
    fleet/meta_parallel/segment_parallel.py:26. Exact attention over the
    sequence blocks of the 'sep' axis is ops/ring_attention.py's
    `ring_attention(q, k, v, "sep", ...)`."""
    pass
