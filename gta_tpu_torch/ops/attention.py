"""Attention similarity and softmax over [B, H, T, C] operands (plain
PyTorch).

Port of gta_tpu/ops/attention.py: the JAX package's XLA paths, which keep
the attention map. The softmax always runs in float32 whatever the compute
dtype; the scores accumulate in fp32 (`preferred_element_type`), the
weights are cast back to v's dtype for the product with v. The layers take
these for the methods JAX computes with XLA on a TPU (an adjustable tau, an
additive bias, euclid similarity, elementwise_mul, rpe: models/layers.py);
the block-diagonal GTA oracle (ops/gta.py) takes them too.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q k^T accumulated in fp32 (for bf16 operands: their exact products
    summed in fp32, XLA's preferred_element_type)."""
    return torch.einsum("bhqc,bhkc->bhqk", q.float(), k.float())


def _softmax_v(sim: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkc->bhqc", attn, v), attn


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    tau: Union[torch.Tensor, float] = 1.0,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale / tau + bias) v. `tau` may be a learnable
    scalar (adjustable softmax, reference layers.py:135-143); `bias` hosts
    e.g. the GBT Plücker-distance term. Returns (out, attn)."""
    sim = _scores(q, k) * scale / tau
    if bias is not None:
        sim = sim + bias
    return _softmax_v(sim, v)


def euclid_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    tau: Union[torch.Tensor, float] = 1.0,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Negative squared distance similarity -0.5 ||q - k||^2 in its expanded
    form q k^T - 0.5 q.q - 0.5 k.k (reference layers.py:213-224), then as
    dot_product_attention."""
    q32, k32 = q.float(), k.float()
    sim = _scores(q, k) - 0.5 * (q32**2).sum(-1)[..., :, None] - 0.5 * (k32**2).sum(-1)[..., None, :]
    sim = sim * scale / tau
    if bias is not None:
        sim = sim + bias
    return _softmax_v(sim, v)
