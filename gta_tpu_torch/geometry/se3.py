"""SE(3) rigid-transform math.

Analytic inverses (rotation transpose) replace linear solves. `scale_mask`
reproduces the learnable translation-coefficient masking of reference
gta.py:40-44: multiplying both rho = inv(E) and its "inverse" E elementwise
by the mask keeps them exact inverses of each other while shrinking the
translation column by trans_coeff.
"""

from __future__ import annotations

import torch


def se3_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of [..., 4, 4] rigid transforms [R, t; 0, 1]."""
    rot = mat[..., :3, :3]
    t = mat[..., :3, 3:]
    rot_t = rot.transpose(-1, -2)
    top = torch.cat([rot_t, -rot_t @ t], -1)  # [..., 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=mat.dtype, device=mat.device)
    bottom = bottom.expand(*mat.shape[:-2], 1, 4)
    return torch.cat([top, bottom], -2)


def scale_mask(trans_coeff, dtype=torch.float32, device=None) -> torch.Tensor:
    """[4, 4] mask: ones except the translation column, which is trans_coeff.

    trans_coeff may be a learnable [1] parameter; the mask stays
    differentiable in it.
    """
    if not isinstance(trans_coeff, torch.Tensor):
        trans_coeff = torch.tensor(float(trans_coeff), dtype=dtype, device=device)
    tc = trans_coeff.to(dtype).reshape(1)
    ones = torch.ones((1,), dtype=dtype, device=tc.device)
    col = torch.cat([tc.expand(3), ones])  # [4]
    return torch.cat([torch.ones((4, 3), dtype=dtype, device=tc.device), col[:, None]], 1)


def homogenize(v: torch.Tensor, trans_coeff: float = 1.0) -> torch.Tensor:
    """Append a constant `trans_coeff` coordinate: [..., K] -> [..., K+1]."""
    return torch.cat([v, torch.full((*v.shape[:-1], 1), trans_coeff, dtype=v.dtype, device=v.device)], -1)


def rigid_transform(mat: torch.Tensor, points: torch.Tensor, trans_coeff: float = 1.0) -> torch.Tensor:
    """Apply [..., 4, 4] rigid transforms to [..., K, 3] points; trans_coeff
    1 transforms points, 0 directions (reference common.py:182-196).

    Each output sums its four products pairwise, (m0 x + m1 y) + (m2 z +
    m3 w), the order XLA's CPU dot takes: repast feeds these points to
    octave encodings up to 2^9 pi, which turn one ulp of a coordinate into
    ~1e-3 of an embedding, so the two packages agree only where they sum
    alike."""
    p = homogenize(points, trans_coeff)[..., None, :]  # [..., K, 1, 4]
    m = mat[..., None, :3, :]  # [..., 1, 3, 4]
    prod = m * p  # [..., K, 3, 4]
    return (prod[..., 0] + prod[..., 1]) + (prod[..., 2] + prod[..., 3])
