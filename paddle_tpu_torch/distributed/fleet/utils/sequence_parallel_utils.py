"""Megatron-style sequence parallelism over the 'mp' mesh axis.
reference: paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py,
after fleet/utils/sequence_parallel_utils.py (ScatterOp:85 / GatherOp /
AllGatherOp / ReduceScatterOp, ColumnSequenceParallelLinear:427,
RowSequenceParallelLinear, the allreduce hooks for SP params :192).

Each "op" marks its output with the sequence dim sharded (or not) over
'mp' (meta_parallel/parallel_layers._constrain): the global value passes
through unchanged, as the reference's ops are value-identities, and
autograd carries the gradient back unchanged. Layout as the reference's:
activations are [s, b, h] and the sequence dim is axis 0.
"""

from __future__ import annotations

from ....nn import functional as F
from ....nn.layer.layers import Layer
from ..meta_parallel.parallel_layers import _constrain, _device, _shard_param

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "scatter", "all_gather", "reduce_scatter",
    "mark_as_sequence_parallel_parameter",
    "is_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
]

_SP_AXIS = "mp"  # Megatron SP reuses the tensor-parallel group


def _seq_spec(ndim, axis, shard):
    spec = [None] * ndim
    if shard:
        spec[axis] = _SP_AXIS
    return tuple(spec)


def scatter(x, axis=0):
    """Replicated -> sequence-sharded over mp (reference ScatterOp.forward:
    a split; its backward the all-gather)."""
    return _constrain(x, _seq_spec(x.ndim, axis, True))


def all_gather(x, axis=0):
    """Sequence-sharded -> replicated (reference GatherOp/AllGatherOp;
    backward reduce-scatters)."""
    return _constrain(x, _seq_spec(x.ndim, axis, False))


def reduce_scatter(x, axis=0):
    """Partial-sum -> sequence-sharded (reference ReduceScatterOp)."""
    return _constrain(x, _seq_spec(x.ndim, axis, True))


class _OpNamespace:
    """The reference exposes these as PyLayers with .apply; keep that
    spelling (`ScatterOp.apply(x)`) alongside the plain call."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, axis=0):
        return self._fn(x, axis)

    def apply(self, x, axis=0):
        return self._fn(x, axis)


ScatterOp = _OpNamespace(scatter)
GatherOp = _OpNamespace(all_gather)
AllGatherOp = _OpNamespace(all_gather)
ReduceScatterOp = _OpNamespace(reduce_scatter)


def mark_as_sequence_parallel_parameter(parameter):
    """reference: sequence_parallel_utils.py:176. Params of layers that
    consume seq-sharded activations (layernorm/bias between the row and
    column linears) need their grads summed over mp; with the global
    value in one process they already are, so the mark is metadata only,
    as in the reference."""
    parameter.__dict__["sequence_parallel"] = True
    return parameter


def is_sequence_parallel_parameter(parameter):
    return bool(parameter.__dict__.get("sequence_parallel", False))


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse_allreduce=False):
    """reference: sequence_parallel_utils.py:192. Nothing to reduce with
    the global value in one process; validates the marks so ported code
    fails loudly if it never marked anything."""
    marked = [p for p in model.parameters()
              if is_sequence_parallel_parameter(p)]
    if not marked:
        import warnings
        warnings.warn(
            "register_sequence_parallel_allreduce_hooks: no parameter is "
            "marked with mark_as_sequence_parallel_parameter — in the "
            "reference this means SP-param grads would silently miss their "
            "mp allreduce; mark layernorm/bias params between the row and "
            "column linears", RuntimeWarning, stacklevel=2)
    return marked


class ColumnSequenceParallelLinear(Layer):
    """Column-parallel linear whose input arrives sequence-sharded.

    reference: sequence_parallel_utils.py:427. Forward: all-gather the
    sequence dim (axis 0 of [s, b, h]) over mp, matmul with the
    output-sharded weight, keep the output feature-sharded
    (gather_output=False is the only mode, as in the reference).
    """

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        if gather_output:
            raise ValueError(
                "ColumnSequenceParallelLinear gathers the sequence dim, not "
                "the output dim; gather_output must be False "
                "(reference sequence_parallel_utils.py:459)")
        self.weight = self.create_parameter((in_features, out_features),
                                            attr=weight_attr,
                                            device=_device())
        self.bias = (self.create_parameter((out_features,), is_bias=True,
                                           device=_device())
                     if has_bias else None)
        _shard_param(self.weight, (None, _SP_AXIS))
        if self.bias is not None:
            _shard_param(self.bias, (_SP_AXIS,))

    def forward(self, x):
        x = all_gather(x, axis=0)                    # [s/mp,b,h] -> [s,b,h]
        out = F.linear(x, self.weight, self.bias)
        # feature (last dim) stays sharded on mp, like the reference
        return _constrain(out, _seq_spec(out.ndim, out.ndim - 1, True))


class RowSequenceParallelLinear(Layer):
    """Row-parallel linear whose output leaves sequence-sharded.

    reference: sequence_parallel_utils.py (RowSequenceParallelLinear).
    Forward: matmul with the input-sharded weight (input arrives
    feature-sharded from the column linear), then reduce-scatter the
    partial sums over the sequence dim — output is [s/mp, b, h].
    """

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter((in_features, out_features),
                                            attr=weight_attr,
                                            device=_device())
        self.bias = (self.create_parameter((out_features,), is_bias=True,
                                           device=_device())
                     if has_bias else None)
        _shard_param(self.weight, (_SP_AXIS, None))

    def forward(self, x):
        if not self.input_is_parallel:
            x = _constrain(x, _seq_spec(x.ndim, x.ndim - 1, True))
        out = F.linear(x, self.weight, None)
        out = reduce_scatter(out, axis=0)            # [s,b,h] -> [s/mp,b,h]
        if self.bias is not None:
            out = out + self.bias
        return out
