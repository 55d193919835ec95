"""Flash attention: softmax(q k^T * scale) v without the attention matrix.

Port of gta_tpu/ops/flash.py `flash_attention`, the path the JAX package's
attention layers take for plain dot-product attention with flash on (on a
TPU: methods '', ape, mln and frustum_posemb under the standard softmax;
and, through flash_core, GTA's sliced path, ops/gta_pallas.py). The JAX function sends key
lengths up to 2048 to its own flash_core kernel and longer ones to JAX's
stock Pallas flash attention with padding glue; the port's flash_core
forward tiles K with an online softmax, so every key length takes it and no
second branch exists. Operands are token-major [B, T, H*C], as the layer's
projections produce them (the JAX function takes heads-first [B, H, T, C]).
"""

from __future__ import annotations

from typing import Optional

import torch

from gta_tpu_torch.ops.flash_core import flash_core


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    sm_scale: float = 1.0,
    mxu_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v over token-major [B, T, H*C] operands:
    the plain version on CPU tensors, the flash_core kernels on CUDA
    tensors (differentiable); any other device raises. `mxu_dtype` as in
    ops/flash_core.flash_core (bf16 products on fp32 rows)."""
    return flash_core(q, k, v, heads, sm_scale, mxu_dtype)
