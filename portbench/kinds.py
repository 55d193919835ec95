"""The kind of a device kernel, by its name.

A frozen copy of `gta_tpu_torch/scripts/profile_serving._kind`, kept here
so that the program can rename or remove its profiling scripts without
moving the yardstick. Each attention core (fp32 `csrc/attn_core.cuh`, bf16
`csrc/attn_sm90.cuh`) serves both attention entries (the fused GTA kernels
and flash_core), so their kernels are one kind, counted under the entry
the configuration launches.
"""

from __future__ import annotations

ATTENTION = ("attention_fwd", "attention_bwd", "attention_rows", "attention_centres")


def kind(name: str) -> str:
    """One of ATTENTION, "convolution", "gemm", "memcpy" or "other"
    (elementwise, normalisation, reduction)."""
    n = name.lower()
    if "attn_fwd" in n or "sm90_fwd" in n:
        return "attention_fwd"
    if "attn_bwd" in n or "sm90_bwd" in n or "gta_bwd" in n:  # the core's passes; GTA's dM reductions
        return "attention_bwd"
    if "gta_rows" in n and "centre" not in n:  # the C x C chains of the fused GTA kernels
        return "attention_rows"
    if "mean_rows" in n or "centre" in n:
        return "attention_centres"
    # cuDNN's conv algorithms (implicit GEMM "fprop", FFT, layout
    # transforms), checked before "gemm", which implicit-GEMM names contain
    if any(m in n for m in ("conv", "fprop", "fft", "pointwise_mult_and_sum_complex", "nhwctonchw", "cudnn")):
        return "convolution"
    if "gemm" in n or "nvjet" in n:  # cuBLAS (nvjet: its Hopper kernels)
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    return "other"
