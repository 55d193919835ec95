"""Synthetic multi-view sphere scenes — dataset-free fixtures.

Analytic scenes (colored spheres on a gradient background, Lambertian-ish
shading) rendered by ray-sphere intersection: in C++ threads
(`data/native.py`, float32) by default, as the JAX package does
(gta_tpu/data/synthetic.py:62), or in vectorized numpy (float64, the plain
version) with `use_native=False`. Items have
the CLEVR-TR batch structure (canonicalized camera frames, relative
transforms, sampled target pixels — reference clevr_tr.py:234-327), so
tests, evaluation and the chip smoke run need no dataset download.
Deterministic per (seed, index): the same seed gives the same arrays as the
JAX package's renderer of the same kind.
"""

from __future__ import annotations

import numpy as np
import torch

from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data.native import render_views
from gta_tpu_torch.data.sampling import points_per_view
from gta_tpu_torch.geometry.coords import make_2dcoord
from gta_tpu_torch.geometry.rays import (
    camera_rays_from_extrinsic,
    lookat_extrinsic,
    transform_points,
)
from gta_tpu_torch.models.context import SceneBatch


def _render(camera_pos, rays, spheres):
    """Ray-trace spheres: rays [H, W, 3], spheres (centers [K,3], radii [K],
    colors [K,3]). Returns [H, W, 3] float32 in [0, 1]."""
    centers, radii, colors = spheres
    d = rays[None]  # [1, H, W, 3]
    oc = (camera_pos[None] - centers)[:, None, None, :]  # [K, 1, 1, 3]
    b = np.sum(oc * d, -1)  # [K, H, W]
    c = np.sum(oc * oc, -1) - radii[:, None, None] ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    t = np.where(hit & (t > 1e-3), t, np.inf)  # [K, H, W]
    k_near = np.argmin(t, 0)  # [H, W]
    t_near = np.min(t, 0)
    hit_any = np.isfinite(t_near)

    # shading: normal · light
    t_fin = np.where(hit_any, t_near, 1.0)
    p = camera_pos[None, None] + rays * t_fin[..., None]
    n = p - centers[k_near]
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    light = np.array([0.4, 0.3, 0.85])
    light /= np.linalg.norm(light)
    shade = 0.35 + 0.65 * np.clip(np.sum(n * light, -1), 0, 1)
    obj = colors[k_near] * shade[..., None]

    # background: vertical gradient on ray z
    bg = 0.5 + 0.4 * rays[..., 2:3] * np.array([0.6, 0.7, 1.0])[None, None]
    img = np.where(hit_any[..., None], obj, bg)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


class SyntheticScenes:
    """Map-style synthetic dataset mirroring the CLEVR-TR item structure."""

    def __init__(self, cfg: DataConfig, mode: str = "train", num_scenes: int = 10000,
                 full_scale: bool = False, seed: int = 0, max_len=None, use_native: bool = True):
        self.cfg = cfg
        self.mode = mode
        self.full_scale = full_scale
        self.use_native = use_native
        self.num_scenes = max_len or num_scenes
        base = {"train": 0, "val": 1 << 20, "test": 1 << 21}[mode]
        self.seed_base = seed * (1 << 22) + base
        ds = cfg.downsample
        self.h = cfg.height // (2**ds) if ds else cfg.height
        self.w = cfg.width // (2**ds) if ds else cfg.width
        # Full-scale protocol (reference evaluate.py:61,90-91): `downsample`
        # shrinks only the *input* views; full-scale test targets are scored
        # at the dataset's native height/width.
        self.target_h, self.target_w = (
            (cfg.height, cfg.width) if (full_scale and ds) else (self.h, self.w)
        )
        self.coord = make_2dcoord(self.h, self.w)
        stride = 2**cfg.downsample_input_coord
        self.input_coord_ds = self.coord[stride // 2 :: stride, stride // 2 :: stride].reshape(-1, 2)

    def __len__(self):
        return self.num_scenes

    def _native_targets(self, cam_pos, extrinsics, spheres, idxs):
        """Render the given views at the dataset-native (pre-`downsample`)
        resolution; called after every RNG draw in __getitem__ so the
        full-scale split sees the same scene stream as the training split."""
        return self._render_views(cam_pos[idxs], extrinsics[idxs], spheres, self.target_h, self.target_w)

    def _render_views(self, cam_pos, extrinsics, spheres, h, w):
        """(images, rays) [NV, h, w, 3] of the given cameras."""
        if self.use_native:
            return render_views(cam_pos, extrinsics, *spheres, h, w)
        rays = np.stack([camera_rays_from_extrinsic(e, p, w, h) for e, p in zip(extrinsics, cam_pos)])
        imgs = np.stack([_render(p, r, spheres) for p, r in zip(cam_pos, rays)])
        return imgs, rays

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        rng = np.random.RandomState(self.seed_base + idx)
        n_spheres = rng.randint(3, 7)
        centers = np.stack(
            [rng.uniform(-3, 3, n_spheres), rng.uniform(-3, 3, n_spheres), rng.uniform(0.3, 1.8, n_spheres)],
            -1,
        )
        radii = rng.uniform(0.4, 1.1, n_spheres)
        colors = rng.uniform(0.1, 1.0, (n_spheres, 3))
        spheres = (centers, radii, colors)

        # cameras on a shell looking at the origin
        NV = cfg.num_views
        az = rng.uniform(0, 2 * np.pi, NV)
        el = rng.uniform(0.25, 0.9, NV)
        r = rng.uniform(7.0, 10.0, NV)
        cam_pos = np.stack(
            [r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el), r * np.sin(el)], -1
        ).astype(np.float32)

        extrinsics = np.stack([lookat_extrinsic(p) for p in cam_pos])
        imgs, all_rays = self._render_views(cam_pos, extrinsics, spheres, self.h, self.w)

        input_idx = rng.choice(NV, size=cfg.num_input_views, replace=False)
        if cfg.reconstruction:
            target_idx = input_idx
        elif cfg.overlap:
            target_idx = rng.choice(NV, size=cfg.num_target_views, replace=False)
        else:
            remaining = sorted(set(range(NV)) - set(input_idx))
            target_idx = rng.choice(remaining, size=cfg.num_target_views, replace=False)

        # canonicalize in the first input view's frame (clevr_tr.py:234-249)
        canon = extrinsics[input_idx[0]].copy()
        if cfg.avoid_zerocamorg:
            canon[:3, 3] += 0.01
        if cfg.canonical_view:
            rays_c = transform_points(all_rays, canon, translate=False)
            pos_c = transform_points(cam_pos, canon)
            inv_canon = np.linalg.inv(canon)
            input_tf = np.stack([extrinsics[i] @ inv_canon for i in input_idx]).astype(np.float32)
            target_tf = np.stack([extrinsics[i] @ inv_canon for i in target_idx]).astype(np.float32)
        else:
            rays_c, pos_c = all_rays, cam_pos
            input_tf = extrinsics[input_idx].astype(np.float32)
            target_tf = extrinsics[target_idx].astype(np.float32)

        input_images = imgs[input_idx]
        input_rays = rays_c[input_idx].astype(np.float32)
        input_camera_pos = pos_c[input_idx].astype(np.float32)

        full_native = self.full_scale and (self.target_h, self.target_w) != (self.h, self.w)

        if not cfg.return_transform:
            # Non-transform mode (clevr_tr.py:313-327): actual target-view
            # rays/positions, flattened across views.
            if full_native:
                t_imgs, t_cam_rays = self._native_targets(cam_pos, extrinsics, spheres, target_idx)
                t_rays_v = (
                    transform_points(t_cam_rays, canon, translate=False)
                    if cfg.canonical_view else t_cam_rays
                )
                t_rays = t_rays_v.reshape(-1, 3).astype(np.float32)
                t_pos = np.repeat(
                    pos_c[target_idx], self.target_h * self.target_w, 0
                ).astype(np.float32)
                t_pix = t_imgs.reshape(-1, 3)
            else:
                t_rays = rays_c[target_idx].reshape(-1, 3).astype(np.float32)
                t_pos = np.repeat(pos_c[target_idx], self.h * self.w, 0).astype(np.float32)
                t_pix = imgs[target_idx].reshape(-1, 3)
            if not self.full_scale:
                sel = rng.choice(len(t_pix), size=cfg.num_points, replace=False)
                t_pix, t_rays, t_pos = t_pix[sel], t_rays[sel], t_pos[sel]
            return {
                "input_images": input_images,
                "input_camera_pos": input_camera_pos,
                "input_rays": input_rays,
                "target_pixels": t_pix.astype(np.float32),
                "target_camera_pos": t_pos,
                "target_rays": t_rays,
                "input_transforms": input_tf,
                "transform": canon.astype(np.float32),
                "sceneid": np.int32(idx),
            }

        # target rays are the canonical view's grid re-used per target view
        # (clevr_tr.py:275-311): pixels come from target images, rays from
        # the canonical camera — the transform carries the view change.
        if full_native:
            t_imgs, _ = self._native_targets(cam_pos, extrinsics, spheres, target_idx)
            rays0 = camera_rays_from_extrinsic(
                extrinsics[input_idx[0]], cam_pos[input_idx[0]],
                self.target_w, self.target_h,
            )
            if cfg.canonical_view:
                rays0 = transform_points(rays0, canon, translate=False)
            base_rays = rays0.reshape(-1, 3).astype(np.float32)
            base_pos = np.broadcast_to(
                input_camera_pos[0], (self.target_h * self.target_w, 3)
            )
            base_coord = make_2dcoord(self.target_h, self.target_w).reshape(-1, 2)
            tgt_pixels = t_imgs.reshape(cfg.num_target_views, -1, 3)
        else:
            base_rays = input_rays[0].reshape(-1, 3)
            base_pos = np.broadcast_to(input_camera_pos[0], (self.h * self.w, 3))
            base_coord = self.coord.reshape(-1, 2)
            tgt_pixels = imgs[target_idx].reshape(cfg.num_target_views, -1, 3)

        if not self.full_scale:
            ppv = points_per_view(cfg.num_points, cfg.num_target_views)
            px, rs, cp, co = [], [], [], []
            for i in range(cfg.num_target_views):
                sel = rng.choice(self.h * self.w, size=ppv, replace=self.h * self.w < ppv)
                px.append(tgt_pixels[i, sel])
                rs.append(base_rays[sel])
                cp.append(base_pos[sel])
                co.append(base_coord[sel])
            target_pixels = np.stack(px)
            target_rays = np.stack(rs)
            target_camera_pos = np.stack(cp)
            target_coord = np.stack(co)
        else:
            target_pixels = tgt_pixels
            target_rays = np.stack([base_rays] * cfg.num_target_views)
            target_camera_pos = np.stack([base_pos] * cfg.num_target_views)
            target_coord = np.stack([base_coord] * cfg.num_target_views)

        return {
            "input_images": input_images,
            "input_camera_pos": input_camera_pos,
            "input_rays": input_rays,
            "target_pixels": target_pixels.astype(np.float32),
            "target_camera_pos": target_camera_pos.astype(np.float32),
            "target_rays": target_rays.astype(np.float32),
            "input_transforms": input_tf,
            "target_transforms": target_tf,
            "input_coord": np.stack([self.input_coord_ds] * cfg.num_input_views),
            "target_coord": target_coord.astype(np.float32),
            "transform": canon.astype(np.float32),
            "sceneid": np.int32(idx),
        }


_BATCH_KEYS = [f for f in SceneBatch.__dataclass_fields__]


def collate(items) -> SceneBatch:
    """Stack a list of item dicts into a SceneBatch of CPU tensors."""
    stacked = {
        k: torch.from_numpy(np.stack([it[k] for it in items]))
        for k in _BATCH_KEYS
        if k in items[0]
    }
    return SceneBatch(**stacked)
