"""Plücker ray parameterization and pairwise ray distance (GBT baseline).

Port of gta_tpu/geometry/plucker.py (reference source/utils/gbt.py), with
the distance branch-free (`torch.where`), as the JAX package has it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def plucker_params(ray: torch.Tensor) -> torch.Tensor:
    """(origin, direction) [..., 6] -> Plücker (d, o x d) [..., 6]."""
    o, d = ray[..., :3], ray[..., 3:]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.cat([d, torch.linalg.cross(o, d, dim=-1)], -1)


def plucker_dist(ray1: torch.Tensor, ray2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Pairwise distance between Plücker rays: [B, Q, 6] x [B, P, 6] -> [B, Q, P].

    Skew lines: |l1.m2 + l2.m1| / ||l1 x l2||; parallel lines:
    ||l1 x (m1 - m2)|| / ||l1||^2 (reference gbt.py:61-96).
    """
    r1, r2 = ray1[:, :, None], ray2[:, None, :]  # [B, Q, 1, 6], [B, 1, P, 6]
    l1, m1 = r1[..., :3], r1[..., 3:]
    l2, m2 = r2[..., :3], r2[..., 3:]
    reci = torch.abs((l1 * m2).sum(-1) + (l2 * m1).sum(-1))  # [B, Q, P]
    shape = (*reci.shape, 3)
    l1b = l1.expand(shape)
    l1xl2_n = torch.linalg.norm(torch.linalg.cross(l1b, l2.expand(shape), dim=-1), dim=-1)
    l1x_dm = torch.linalg.cross(l1b, (m1 - m2).expand(shape), dim=-1)
    par = torch.linalg.norm(l1x_dm, dim=-1) / ((l1 * l1).sum(-1) + eps)
    skew = reci / (l1xl2_n + eps)
    return torch.where(l1xl2_n > eps, skew, par)


def plucker_posenc(ray: torch.Tensor, n_freqs: int = 15, start_freq: int = -6,
                   parameterize: Optional[str] = None) -> torch.Tensor:
    """NeRF-style frequency encoding of the last axis (reference
    gbt.py:7-39): all sines over the frequencies, then all cosines, each
    block [..., F * n_freqs], frequency-major."""
    if parameterize == "plucker":
        ray = plucker_params(ray)
    freqs = (2.0 ** torch.arange(start_freq, start_freq + n_freqs, dtype=ray.dtype, device=ray.device)) * math.pi
    scaled = ray[..., None, :] * freqs[:, None]  # [..., F, D]
    flat = scaled.reshape(*ray.shape[:-1], -1)
    return torch.cat([torch.sin(flat), torch.cos(flat)], -1)
