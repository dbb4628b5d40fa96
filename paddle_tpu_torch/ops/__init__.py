"""The port's operators: flash attention (the CUDA kernels K1-K4 and their
plain versions), the attention router, ring attention over sequence shards
(K1 once a ring step), paged attention and the kernel autotuner.
reference: paddle_tpu/ops/."""

from . import autotune  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
