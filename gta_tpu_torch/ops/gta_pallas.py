"""GTA attention through the hand-written kernels: the fused GTA kernels
where they cover the call, else the sliced rep transforms around flash_core.

Port of gta_tpu/ops/gta_pallas.py:45 `fused_gta_attention`, the path the
JAX package's GTA layers take on a TPU (static tau, no euclid_sim, no
elementwise_mul): the fully fused kernel where `v2_supported` holds,
otherwise `gta_transform_qkv` (XLA there, torch here), the flash_core
kernels (kernel rows 3-4), then `gta_untransform_out`. Gradients for q, k,
v, trans_coeff and the rep tables flow through torch autograd of the
transforms and flash_core's backward kernel.

The Pallas kernel's own limits (whole K/V in VMEM up to 2048 keys, 8-row
aligned blocks, gta_tpu/ops/gta_fused.py:504) do not bind the port's fused
kernels, which tile K with an online softmax: here the fused path covers
every block-diagonal rep mix (no t2, no euclid, no per-token SE(3), even
spans where there are rotors), the others (gta_t2, ray_to_se3) take the
sliced path. Both compute the same function.

Operands are token-major [B, T, H*C], as the layer's projections produce
them. On the sliced path, the transforms compute in the rep tables' fp32
(ops/gta.py, as jnp.einsum promotes), and flash_core takes the transformed
q, k, v in that fp32, as the JAX function hands them to its kernel: under
mixed precision (bf16 operands) with bf16 products (`mxu_dtype`, the TPU
kernel's rounding of its product operands) and its output and gradients in
fp32, which the output's inverse transform takes on in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.ops.flash import flash_attention
from gta_tpu_torch.ops.flash_core import merge_heads, split_heads
from gta_tpu_torch.ops.gta import _blockdiag_ok, gta_transform_qkv, gta_untransform_out
from gta_tpu_torch.ops.gta_fused import fused_gta_attention_tokens
from gta_tpu_torch.ops.reps import GeomReps


def v2_supported(reps: GeomReps, args: GTAArgs) -> bool:
    """Whether the fused GTA kernels cover the call (the port's form of
    gta_tpu/ops/gta_fused.py:504 `v2_supported`)."""
    return not args.elementwise_mul and _blockdiag_ok(reps, args)


def fused_gta_attention(
    qB: torch.Tensor,
    kB: torch.Tensor,
    vB: torch.Tensor,
    heads: int,
    reps: GeomReps,
    args: GTAArgs,
    trans_coeff: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """GTA attention over token-major [B, T, H*C] operands (C ==
    f_dims.total) with no attention map: the fused GTA kernels, or the
    sliced transforms around flash_core. CPU tensors take the kernels'
    plain versions; CUDA tensors launch the kernels or raise."""
    if args.euclid_sim or args.elementwise_mul:
        raise ValueError("euclid_sim and elementwise_mul GTA run in torch eager (ops/gta.gta_attention)")
    if v2_supported(reps, args):
        return fused_gta_attention_tokens(qB, kB, vB, heads, reps, args, trans_coeff, scale)
    q, k, v = (split_heads(x, heads) for x in (qB, kB, vB))
    qt, kt, vt = (merge_heads(x) for x in gta_transform_qkv(q, k, v, reps, args, trans_coeff))
    out = flash_attention(qt, kt, vt, heads, float(scale), mxu_dtype=qB.dtype)
    if args.v_transform:
        out = merge_heads(gta_untransform_out(split_heads(out, heads), reps, args, trans_coeff))
    return out
