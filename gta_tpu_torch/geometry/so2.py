"""SO(2) rotary representations over image coordinates.

Rotors are stored as (cos, sin) tables and applied RoPE-style with
elementwise math instead of [..., 2, 2] matrices.

Frequency ladder (reference gta.py:57-63 — note: NOT the standard RoPE
ladder): freqs[j] = 2^(j+1) / 2^n for j = 0..n-1, ascending, and
theta[..., d, j] = max_freqs[d] * 2*pi * coord[..., d] * freqs[j].
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _freq_ladder(nfreqs: int, shared_freqs: bool, dtype, device) -> torch.Tensor:
    if shared_freqs:
        return torch.ones((nfreqs,), dtype=dtype, device=device)
    exps = torch.arange(1.0, nfreqs + 1.0, dtype=dtype, device=device)
    return torch.pow(2.0, exps) / (2.0**nfreqs)


def so2_angles(
    coord: torch.Tensor,
    nfreqs: int,
    max_freqs: Sequence[float] = (1.0, 1.0),
    shared_freqs: bool = False,
) -> torch.Tensor:
    """Rotor angles for each (coordinate dim, frequency) pair.

    coord: [..., D]. Returns theta [..., nfreqs*D], FREQUENCY-major
    (rotor c = f*D + d) — the reference's channel interleave.
    """
    dim = coord.shape[-1]
    freqs = _freq_ladder(nfreqs, shared_freqs, coord.dtype, coord.device)  # [F]
    mf = torch.tensor(list(max_freqs)[:dim], dtype=coord.dtype, device=coord.device)  # [D]
    theta = 2.0 * math.pi * (mf * coord)[..., None, :] * freqs[:, None]  # [..., F, D]
    return theta.reshape(*coord.shape[:-1], dim * nfreqs)


def apply_rotor(cos: torch.Tensor, sin: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Left-multiply 2-vectors x [..., C, 2] by R(theta): (c*x0 - s*x1, s*x0 + c*x1)."""
    x0, x1 = x[..., 0], x[..., 1]
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], -1)


def apply_rotor_inv(cos: torch.Tensor, sin: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Left-multiply by R(theta)^T = R(-theta)."""
    x0, x1 = x[..., 0], x[..., 1]
    return torch.stack([cos * x0 + sin * x1, -sin * x0 + cos * x1], -1)


def make_so2_mats(
    coord: torch.Tensor,
    nfreqs: int,
    max_freqs: Sequence[float] = (1.0, 1.0),
    shared_freqs: bool = False,
) -> torch.Tensor:
    """Full rotation matrices [..., D*nfreqs, 2, 2] (reference form
    gta.py:47-69), for the flattened-rep (elementwise_mul) ablation."""
    theta = so2_angles(coord, nfreqs, max_freqs, shared_freqs)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
