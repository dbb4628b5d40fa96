"""The port's operators: flash attention (the CUDA kernels K1-K4 and their
plain versions), the attention router and paged attention. reference:
paddle_tpu/ops/."""
