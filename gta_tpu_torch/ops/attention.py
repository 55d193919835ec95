"""Dot-product attention over [B, H, T, C] operands (plain PyTorch).

The softmax always runs in float32 regardless of compute dtype. This is the
JAX package's XLA path with its attention map; the attention layers take
flash attention instead (ops/flash.py), as the JAX package does with flash
on, and this function serves the block-diagonal GTA oracle (ops/gta.py).
"""

from __future__ import annotations

from typing import Tuple

import torch


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v. Returns (out, attn)."""
    sim = torch.einsum("bhqc,bhkc->bhqk", q.float(), k.float()) * scale
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkc->bhqc", attn, v)
    return out, attn
