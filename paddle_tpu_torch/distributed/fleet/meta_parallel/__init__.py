"""Meta-parallel wrappers and the tensor-parallel layers. reference:
paddle_tpu/distributed/fleet/meta_parallel/__init__.py."""

from .parallel_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    SegmentParallel, ShardingParallel, TensorParallel, VocabParallelEmbedding)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .pipeline_parallel import PipelineParallel  # noqa: F401
