"""gta_tpu_torch — the PyTorch/CUDA port of gta_tpu for NVIDIA Hopper GPUs.

Mirrors gta_tpu's module layout. Plain tensor code is PyTorch; the Pallas
TPU kernels become hand-written CUDA kernels under csrc/, built with nvcc on
first use. The package imports nothing from gta_tpu, JAX or flax.
"""
