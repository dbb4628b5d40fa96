"""The port's operators: flash attention (the CUDA kernels K1-K4 and their
plain versions), the attention router, paged attention and the kernel
autotuner. reference: paddle_tpu/ops/."""

from . import autotune  # noqa: F401
