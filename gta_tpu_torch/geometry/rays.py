"""Pinhole camera ray grids, look-at extrinsics, point transforms, and
per-ray rotation frames.

Numpy builders for host-side dataset construction (`ray_to_rotation` is a
torch function of the model's rays). Conventions mirror the
reference (source/utils/nerf.py:7-53, 131-237): world z is up, cameras are
level, camera rows are (right, down-ish y, forward), focal 0.035 / sensor
0.032.
"""

from __future__ import annotations

import numpy as np
import torch


def lookat_extrinsic(camera_pos: np.ndarray, track_point=None, fourxfour: bool = True) -> np.ndarray:
    """World->camera extrinsic for a level camera at camera_pos looking at
    track_point (reference nerf.py:7-53, track_point branch)."""
    camera_pos = np.asarray(camera_pos, dtype=np.float64)
    if track_point is None:
        track_point = np.zeros(3)
    camera_z = track_point - camera_pos
    camera_z = camera_z / np.linalg.norm(camera_z, axis=-1, keepdims=True)
    vertical = np.array((0.0, 0.0, 1.0))
    camera_x = np.cross(camera_z, vertical)
    camera_x = camera_x / np.linalg.norm(camera_x, axis=-1, keepdims=True)
    camera_y = np.cross(camera_z, camera_x)
    R = np.stack((camera_x, camera_y, camera_z), -2)
    t = -np.einsum("...ij,...j->...i", R, camera_pos)
    mat = np.concatenate((R, t[..., None]), -1)
    if fourxfour:
        mat = np.concatenate((mat, np.array([[0.0, 0.0, 0.0, 1.0]])), 0)
    return mat.astype(np.float32)


def camera_rays_from_extrinsic(
    extrinsic: np.ndarray,
    camera_pos: np.ndarray,
    width: int = 320,
    height: int = 240,
    focal_length: float = 0.035,
    sensor_width: float = 0.032,
) -> np.ndarray:
    """Unit ray directions [h, w, 3] from extrinsic basis rows.

    front/right/up taken from extrinsic rows 2/0/1 (reference
    clevr_tr.py:223-232 with nerf.py:197-237).
    """
    right = extrinsic[0, :3]
    up = extrinsic[1, :3]
    front = extrinsic[2, :3]
    camera_pos = np.asarray(camera_pos, dtype=np.float64)

    img_plane_center = camera_pos + front * focal_length
    sensor_height = (sensor_width / width) * height

    hb = np.linspace(-1, 1, width + 1) * sensor_width / 2
    vb = np.linspace(-1, 1, height + 1) * sensor_height / 2
    h_off = (hb[:-1] + hb[1:]) / 2  # pixel centers
    v_off = (vb[:-1] + vb[1:]) / 2
    h_off = np.repeat(h_off[None, :], height, 0)
    v_off = np.repeat(v_off[:, None], width, 1)

    plane = (
        h_off[..., None] * right[None, None]
        + v_off[..., None] * up[None, None]
        + img_plane_center[None, None]
    )
    rays = plane - camera_pos[None, None]
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays.astype(np.float32)


def transform_points(points, transform, translate: bool = True):
    """Apply [..., 4, 4] (or [3, 4]) maps to [..., 3] points (numpy).

    Matches reference nerf.py:73-110 broadcasting: `transform` batch dims
    broadcast against `points` batch dims.
    """
    const = np.ones_like(points[..., :1]) if translate else np.zeros_like(points[..., :1])
    p = np.concatenate((points, const), axis=-1)
    out = np.einsum("...nm,...m->...n", transform, p)
    return out[..., :3]


def ray_to_rotation(rays: torch.Tensor, return_4x4: bool = False) -> torch.Tensor:
    """Per-ray rotation R whose columns are (right, up, ray), with world z as
    the up reference and world x where a ray is parallel to z: [..., 3] unit
    directions -> [..., 3, 3] (or [..., 4, 4]). The JAX package's own
    construction for the reference's `ray_to_se3` hook
    (gta_tpu/geometry/rays.py:106)."""
    z = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    vertical = torch.tensor([0.0, 0.0, 1.0], dtype=rays.dtype, device=rays.device).expand(z.shape)
    x = torch.linalg.cross(z, vertical, dim=-1)
    nx = torch.linalg.norm(x, dim=-1, keepdim=True)
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=rays.dtype, device=rays.device).expand(z.shape)
    x = torch.where(nx > 1e-6, x / torch.clamp(nx, min=1e-12), fallback)
    R = torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], -1)
    if not return_4x4:
        return R
    out = torch.zeros((*R.shape[:-2], 4, 4), dtype=rays.dtype, device=rays.device)
    out[..., :3, :3] = R
    out[..., 3, 3] = 1.0
    return out
