"""CLEVR-TR dataset: posed multi-view CLEVR with scene transformations (the
JAX package's gta_tpu/data/clevrtr.py, item for item).

Disk layout (reference clevr_tr.py:148-208): {path}/{train,test}/ with
metadata/<scene>.json (Kubric camera quaternions + positions), imgs/
img_<scene>_<view>.png and masks/masks_<scene>_<view>.png; 240x320, 5
views; train dir is split 90/10 into train/val. Items are canonicalized in
the first input view's frame and emit relative transforms E @ inv(E_canon)
(clevr_tr.py:234-249). Optional SE(3) Lie-algebra camera noise on
non-canonical input views (clevr_tr.py:15-37, 217-221).

Images and masks decode through the port's host decoder in C++
(data/native.py; the numpy codec, data/png.py, with `native=False`), all
views of an item in one call, where the JAX package tries its libpng
decoder and then imageio or PIL per file. The arrays are those of the JAX
reader's imageio path: images x / 255 in float32 (a division; the JAX
package's libpng path multiplies by 1 / 255, which differs in the last bit
for 126 of the 256 byte values).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data.native import decode_pngs_gray, decode_pngs_rgb
from gta_tpu_torch.data.png import imread_stack
from gta_tpu_torch.data.sampling import points_per_view
from gta_tpu_torch.geometry.coords import make_2dcoord, make_2dimgcoord
from gta_tpu_torch.geometry.rays import camera_rays_from_extrinsic, transform_points


def quat_to_rotmat(q) -> np.ndarray:
    """[w, x, y, z] quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def camera_basis(kubric_basis: bool = False) -> np.ndarray:
    """(right, up, front) rows of the CLEVR camera basis (clevr_tr.py:47-60)."""
    if kubric_basis:
        X, Y, Z = np.array([1.0, 0, 0]), np.array([0, -1.0, 0]), np.array([0, 0, -1.0])
    else:
        X, Y, Z = np.array([-1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, -1.0])
    return np.stack([X, Y, Z])  # right, up, front


def extrinsic_from_kubric_quat(q, p, kubric_basis: bool = False) -> np.ndarray:
    """World->camera 4x4 from a Kubric camera quaternion + position
    (clevr_tr.py:63-75)."""
    R = camera_basis(kubric_basis).T @ quat_to_rotmat(q).T
    t = -R @ np.asarray(p, dtype=np.float64)
    ext = np.concatenate([R, t[:, None]], -1)
    return np.concatenate([ext, np.array([[0.0, 0.0, 0.0, 1.0]])], 0)


def rays_from_extrinsic(extrinsic, camera_pos, width=320, height=240,
                        focal_length=0.035, sensor_width=0.032) -> np.ndarray:
    return camera_rays_from_extrinsic(
        extrinsic, camera_pos, width, height, focal_length, sensor_width
    )


def se3_noise(extrinsic: np.ndarray, sigma: float, rng) -> np.ndarray:
    """Perturb a rigid transform in its Lie-algebra coordinates."""
    from scipy.spatial.transform import Rotation

    rotvec = Rotation.from_matrix(extrinsic[:3, :3]).as_rotvec()
    lie = np.concatenate([rotvec, extrinsic[:3, 3]])
    lie = lie + sigma * rng.normal(size=6)
    out = np.eye(4)
    out[:3, :3] = Rotation.from_rotvec(lie[:3]).as_matrix()
    out[:3, 3] = lie[3:]
    return out


def _downsample(x: np.ndarray, num_steps: int) -> np.ndarray:
    if not num_steps or num_steps < 1:
        return x
    stride = 2**num_steps
    return x[stride // 2 :: stride, stride // 2 :: stride]


class CLEVRTR:
    """Map-style CLEVR-TR dataset producing the canonical SceneBatch item dict."""

    NUM_MAX_ENTITIES = 7

    def __init__(self, cfg: DataConfig, mode: str, full_scale: bool = False,
                 max_len=None, seed=None, native: bool = True):
        self.cfg = cfg
        self.native = native
        self.mode = mode
        self.full_scale = full_scale
        self.h, self.w = 240, 320
        self.coord = (
            make_2dimgcoord(self.h, self.w) if cfg.image_coord else make_2dcoord(self.h, self.w)
        )
        self.render_kwargs = {"min_dist": 0.035, "max_dist": 35.0}

        split_dir = os.path.join(cfg.path, "train" if mode in ("train", "val") else "test")
        self.dir = split_dir
        paths = glob.glob(os.path.join(split_dir, "metadata", "*"))
        paths = sorted(paths, key=lambda x: int(os.path.basename(x).strip(".json")))
        if mode == "train":
            paths = paths[: 9 * len(paths) // 10]
        elif mode == "val":
            paths = paths[9 * len(paths) // 10 :]
        if max_len is not None:
            paths = paths[:max_len]
        self.metadata_paths = paths
        # Per-item deterministic sampling: each __getitem__ derives its own
        # RandomState from (seed, epoch, idx), so the loader's thread pool
        # cannot perturb determinism and view selection still varies across
        # epochs (the reference advances a worker-global np.random instead).
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0


    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.metadata_paths)

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        rng = np.random.RandomState(
            (self.seed * 1000003 + self.epoch * 7919 + idx) % (1 << 31)
        )
        meta_path = self.metadata_paths[idx]
        scene_idx = int(os.path.basename(meta_path).strip(".json"))
        with open(meta_path) as f:
            metadata = json.load(f)

        NV = cfg.num_views
        input_idx = rng.choice(NV, size=cfg.num_input_views, replace=False)
        if cfg.reconstruction:
            target_idx = input_idx
        elif cfg.overlap:
            target_idx = rng.choice(NV, size=cfg.num_target_views, replace=False)
        else:
            rest = sorted(set(range(NV)) - set(input_idx))
            target_idx = rng.choice(rest, size=cfg.num_target_views, replace=False)

        img_paths = [
            os.path.join(self.dir, "imgs", f"img_{scene_idx}_{v}.png") for v in range(NV)
        ]
        mask_paths = [
            os.path.join(self.dir, "masks", f"masks_{scene_idx}_{v}.png")
            for v in range(NV)
        ]
        if self.native:  # one thread: the loader's workers decode items in parallel
            imgs = decode_pngs_rgb(img_paths, self.h, self.w, threads=1)
            mask_idx = decode_pngs_gray(mask_paths, self.h, self.w, threads=1)
        else:
            imgs = imread_stack(img_paths)[..., :3].astype(np.float32) / 255.0
            mask_idx = imread_stack(mask_paths)
        masks = np.zeros((NV, self.h, self.w, self.NUM_MAX_ENTITIES), dtype=np.uint8)
        np.put_along_axis(masks, mask_idx[..., None], 1, axis=-1)

        qs = metadata["camera"]["quaternions"]
        cam_pos = np.asarray(metadata["camera"]["positions"], dtype=np.float32)
        extrinsics = np.stack(
            [
                extrinsic_from_kubric_quat(q, p, cfg.kubric_basis)
                for q, p in zip(qs, cam_pos)
            ]
        ).astype(np.float32)

        if cfg.camera_noise > 0:
            for i in input_idx[1:]:
                extrinsics[i] = se3_noise(extrinsics[i], cfg.camera_noise, rng)

        all_rays = np.stack(
            [
                rays_from_extrinsic(extrinsics[i], cam_pos[i], self.w, self.h)
                for i in range(NV)
            ]
        )

        canonical = extrinsics[input_idx[0]].copy()
        if cfg.avoid_zerocamorg:
            canonical[:3, 3] += 0.01
        if cfg.canonical_view:
            rays_c = transform_points(all_rays, canonical, translate=False)
            pos_c = transform_points(cam_pos, canonical)
            inv_canon = np.linalg.inv(canonical)
            input_tf = np.stack([extrinsics[i] @ inv_canon for i in input_idx]).astype(np.float32)
            target_tf = np.stack([extrinsics[i] @ inv_canon for i in target_idx]).astype(np.float32)
        else:
            rays_c, pos_c = all_rays, cam_pos
            input_tf = extrinsics[input_idx]
            target_tf = extrinsics[target_idx]

        input_images = imgs[input_idx]
        input_rays = rays_c[input_idx].astype(np.float32)
        input_masks = masks[input_idx]
        input_camera_pos = pos_c[input_idx].astype(np.float32)

        ds_ic = (cfg.downsample or 0) + cfg.downsample_input_coord
        input_coord = np.stack(
            [_downsample(self.coord, ds_ic).reshape(-1, 2)] * cfg.num_input_views
        )

        # Pre-downsample copies, emitted on request (clevr_tr.py:261,329).
        org_extra = {}
        if cfg.return_org_rays:
            org_extra["input_org_rays"] = input_rays
        if cfg.return_org_images:
            org_extra["org_input_images"] = input_images

        tgt_pixels = imgs[target_idx].reshape(cfg.num_target_views, -1, 3)
        tgt_masks = masks[target_idx].reshape(cfg.num_target_views, -1, self.NUM_MAX_ENTITIES)

        if not cfg.return_transform:
            # Non-transform mode (clevr_tr.py:313-327): actual target rays and
            # positions, flattened across views, sampled without replacement.
            t_rays = rays_c[target_idx].reshape(-1, 3).astype(np.float32)
            t_pos = np.repeat(pos_c[target_idx], self.h * self.w, 0).astype(np.float32)
            t_pix = tgt_pixels.reshape(-1, 3)
            t_msk = tgt_masks.reshape(-1, self.NUM_MAX_ENTITIES)
            if not self.full_scale:
                sel = rng.choice(len(t_pix), size=cfg.num_points, replace=False)
                t_pix, t_rays, t_pos, t_msk = t_pix[sel], t_rays[sel], t_pos[sel], t_msk[sel]
            if cfg.downsample:
                input_images = np.stack([_downsample(im, cfg.downsample) for im in input_images])
                input_rays = np.stack([_downsample(r, cfg.downsample) for r in input_rays])
                input_masks = np.stack([_downsample(m, cfg.downsample) for m in input_masks])
            return {
                "input_images": input_images,
                "input_camera_pos": input_camera_pos,
                "input_rays": input_rays,
                "input_masks": input_masks,
                "target_pixels": t_pix.astype(np.float32),
                "target_camera_pos": t_pos,
                "target_rays": t_rays,
                "target_masks": t_msk,
                "input_transforms": input_tf,
                "transform": canonical.astype(np.float32),
                "sceneid": np.int32(idx),
                **org_extra,
            }

        base_rays = input_rays[0].reshape(-1, 3)
        base_pos = np.broadcast_to(input_camera_pos[0], (self.h * self.w, 3))
        base_coord = self.coord.reshape(-1, 2)

        if not self.full_scale:
            ppv = points_per_view(cfg.num_points, cfg.num_target_views)
            n = self.h * self.w
            px, ms, rs, cp, co = [], [], [], [], []
            for i in range(cfg.num_target_views):
                sel = rng.choice(n, size=ppv, replace=n < ppv)
                px.append(tgt_pixels[i, sel])
                ms.append(tgt_masks[i, sel])
                rs.append(base_rays[sel])
                cp.append(base_pos[sel])
                co.append(base_coord[sel])
            target_pixels, target_masks = np.stack(px), np.stack(ms)
            target_rays, target_camera_pos, target_coord = (
                np.stack(rs),
                np.stack(cp),
                np.stack(co),
            )
        else:
            target_pixels, target_masks = tgt_pixels, tgt_masks
            target_rays = np.stack([base_rays] * cfg.num_target_views)
            target_camera_pos = np.stack([base_pos] * cfg.num_target_views)
            target_coord = np.stack([base_coord] * cfg.num_target_views)

        if cfg.downsample:
            input_images = np.stack([_downsample(im, cfg.downsample) for im in input_images])
            input_rays = np.stack([_downsample(r, cfg.downsample) for r in input_rays])
            input_masks = np.stack([_downsample(m, cfg.downsample) for m in input_masks])

        return {
            "input_images": input_images,
            "input_camera_pos": input_camera_pos,
            "input_rays": input_rays,
            "input_masks": input_masks,
            "target_pixels": target_pixels.astype(np.float32),
            "target_camera_pos": target_camera_pos.astype(np.float32),
            "target_rays": target_rays.astype(np.float32),
            "target_masks": target_masks,
            "input_transforms": input_tf,
            "target_transforms": target_tf,
            "input_coord": input_coord.astype(np.float32),
            "target_coord": target_coord.astype(np.float32),
            "transform": canonical.astype(np.float32),
            "sceneid": np.int32(idx),
            **org_extra,
        }
