"""Frustum positional-embedding geometry (frustum_posemb baseline).

Port of gta_tpu/geometry/frustum.py (reference
source/utils/frustum_posemb.py): normalized pixel coords lifted to D
quadratically spaced depths along the camera frustum and mapped into the
reference frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def normalized_intrinsics(height: int = 240, width: int = 320,
                          focal_length: float = 35.0, sensor_width: float = 32.0) -> np.ndarray:
    """Normalized 3x3 K for CLEVR's camera (frustum_posemb.py:6-10)."""
    fx = focal_length / sensor_width
    fy = focal_length * (width / height) / sensor_width
    return np.array([[fx, 0.0, 0.5], [0.0, fy, 0.5], [0.0, 0.0, 1.0]], dtype=np.float32)


def frustum_pixel_points(
    coords: torch.Tensor,
    cam_to_ref: torch.Tensor,
    D: int,
    intrinsics: Optional[np.ndarray] = None,
    dmin: float = 0.1,
    dmax: float = 10.0,
) -> torch.Tensor:
    """[B, N, T, 2] pixel coords -> [B, N, T, D*4] homogeneous frustum points
    in the frame of `cam_to_ref` [B, N, 4, 4].

    Depth ladder d_i = dmin + (dmax - dmin) / (D (D + 1)) * i (i + 1),
    i = 1..D (quadratic spacing, frustum_posemb.py:27).
    """
    if intrinsics is None:
        intrinsics = normalized_intrinsics()
    inv_K = torch.as_tensor(np.linalg.inv(intrinsics), dtype=coords.dtype, device=coords.device)
    ones = torch.ones((*coords.shape[:-1], 1), dtype=coords.dtype, device=coords.device)
    cam_coords = torch.cat([coords, ones], -1) @ inv_K.T  # [B, N, T, 3]
    points = []
    for i in range(1, D + 1):
        d = dmin + ((dmax - dmin) / (D * (D + 1))) * i * (i + 1)
        points.append(torch.cat([cam_coords * d, ones], -1))  # [B, N, T, 4]
    p3d = torch.einsum("bnij,bntdj->bntdi", cam_to_ref, torch.stack(points, -2))
    return p3d.reshape(*p3d.shape[:-2], -1)
