"""T(2) planar-translation representations (homogeneous 3x3 matrices).

Port of gta_tpu/geometry/t2.py (reference gta.py:72-89, make_T2mats): the
translation sits in the BOTTOM ROW. The inverse is analytic (translation by
-coord), never a linear solve.
"""

from __future__ import annotations

import torch


def make_t2_mats(coord: torch.Tensor) -> torch.Tensor:
    """[..., 2] coords -> [..., 3, 3] homogeneous translation matrices
    [[1, 0, 0], [0, 1, 0], [cx, cy, 1]]: the third channel of each feature
    triple is the accumulator slot, the first two pass through."""
    shape = coord.shape[:-1]
    eye = torch.eye(2, dtype=coord.dtype, device=coord.device).expand(*shape, 2, 2)
    left = torch.cat([eye, coord[..., None, :]], -2)  # [..., 3, 2]
    right = torch.tensor([0.0, 0.0, 1.0], dtype=coord.dtype, device=coord.device)[:, None].expand(*shape, 3, 1)
    return torch.cat([left, right], -1)


def make_t2_mats_inv(coord: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of make_t2_mats: translation by -coord."""
    return make_t2_mats(-coord)


def apply_t2(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply [..., 3, 3] to homogeneous triples x [..., C, 3] (mat
    broadcasts over the C axis)."""
    return torch.einsum("...ij,...cj->...ci", mat, x)
