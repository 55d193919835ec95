"""RealEstate10K / ACID wide-baseline cross-scene rendering datasets (the
JAX package's gta_tpu/data/re10k.py).

The reference keeps its RealEstate10K/ACID experiment ("crsrndr") on a git
branch absent from the snapshot (reference README.md:29-32); BASELINE.json
lists "RealEstate10K/ACID cross-scene rendering" as a target family. This
is the TPU-native build of that data pipeline: the public RealEstate10K
camera-trajectory format (one txt per video: timestamp, normalized
intrinsics fx fy cx cy, 3x4 world-to-camera pose per line; ACID ships the
identical format) with the wide-baseline two-context-view protocol — two
context frames sampled with a temporal gap, target view(s) inside the
interval, SfM scale removed by normalizing the context baseline to 1.

Items match the canonical SceneBatch layout (canonicalized in the first
context frame, relative transforms E @ inv(E_canon)), so the SRT/TSRT/GTA
model stack consumes RealEstate10K unchanged — per-video intrinsics enter
only through the ray grids, which this loader computes.

Disk layout (the common public dump):
    {path}/{train,test}/*.txt                  camera trajectory files
    {path}/{train,test}/frames/{video_id}/{timestamp}.(png|jpg)  frames
A 90/10 split of train/ provides the val set, like the CLEVR-TR loader.

PNG frames decode through the port's own codec (data/png.py); JPEG frames
need PIL, as in the JAX package (its native decoder reads PNG only), and
without it raise. Frames of another size than the config's are resampled by
`resize_area`, numpy's form of the cv2.resize INTER_AREA call the JAX
package makes.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data import png
from gta_tpu_torch.data.sampling import points_per_view
from gta_tpu_torch.geometry.coords import make_2dcoord
from gta_tpu_torch.geometry.rays import transform_points


def parse_camera_file(path: str):
    """Parse one RealEstate10K camera txt.

    Returns (timestamps [N] int64, intrinsics [N, 4] fx fy cx cy normalized,
    extrinsics [N, 4, 4] world->camera). First line is the video URL.
    """
    ts, intr, ext = [], [], []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for ln in lines[1:]:
        vals = ln.split()
        ts.append(int(float(vals[0])))
        nums = np.asarray([float(v) for v in vals[1:]], np.float64)
        intr.append(nums[:4])
        mat = nums[6:18].reshape(3, 4)
        ext.append(np.concatenate([mat, [[0.0, 0.0, 0.0, 1.0]]], 0))
    return (
        np.asarray(ts, np.int64),
        np.asarray(intr, np.float32),
        np.asarray(ext, np.float32),
    )


def rays_from_intrinsics(extrinsic, intrinsics, width: int, height: int) -> np.ndarray:
    """Unit ray directions [H, W, 3] in world coords for normalized pinhole
    intrinsics (fx, fy, cx, cy in image-relative units, RealEstate10K
    convention: x right, y down, z forward; extrinsic is world->camera)."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    uu, vv = np.meshgrid(u, v)  # [H, W]
    d = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    R = np.asarray(extrinsic[:3, :3], np.float64)
    return (d @ R).astype(np.float32)  # R^T d per pixel


def camera_center(extrinsic: np.ndarray) -> np.ndarray:
    """World-space camera origin of a world->camera extrinsic."""
    R = extrinsic[:3, :3]
    return (-R.T @ extrinsic[:3, 3]).astype(np.float32)


def normalize_scene_scale(extrinsics: np.ndarray, i0: int, i1: int) -> np.ndarray:
    """Rescale SfM translations so the (i0, i1) camera baseline is 1.

    RealEstate10K poses carry an arbitrary per-video SfM scale; wide-
    baseline protocols normalize it out so the model sees a consistent
    metric across scenes."""
    c0, c1 = camera_center(extrinsics[i0]), camera_center(extrinsics[i1])
    scale = float(np.linalg.norm(c1 - c0))
    scale = scale if scale > 1e-6 else 1.0
    out = extrinsics.copy()
    out[:, :3, 3] /= scale
    return out


def _imread(path: str) -> np.ndarray:
    if path.endswith(".png"):
        return png.imread(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: no JPEG decoder (PIL is not installed); install PIL, as the JAX package "
            "needs it too, or decode the frames to PNG"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im)


def _area_weights(src: int, dst: int, area: bool) -> np.ndarray:
    """[dst, src] weights of one axis as cv2.resize INTER_AREA takes them
    (imgproc/resize.cpp): with `area` (both axes shrink) each output pixel
    averages the source pixels its cell covers, by the share each covers
    (computeResizeAreaTab); otherwise two taps at cv2's area-mode offsets
    (the generic resize with INTER_AREA's coefficients)."""
    scale, inv = src / dst, dst / src
    wts = np.zeros((dst, src), np.float64)
    for d in range(dst):
        if area:
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, src - f1)
            s2 = min(int(np.floor(f2)), src - 1)
            s1 = min(int(np.ceil(f1)), s2)
            if s1 - f1 > 1e-3:
                wts[d, s1 - 1] = (s1 - f1) / cell
            wts[d, s1:s2] = 1.0 / cell
            if f2 - s2 > 1e-3:
                wts[d, s2] = min(f2 - s2, 1.0, cell) / cell
        else:
            s = int(np.floor(d * scale))
            f = (d + 1) - (s + 1) * inv
            f = 0.0 if f <= 0 else f - np.floor(f)
            if s >= src - 1:
                s, f = src - 1, 0.0
            wts[d, s] += 1.0 - f
            if f:
                wts[d, s + 1] += f
    return wts


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """img [H, W, C] float32 resampled to [h, w, C] as cv2.resize(img, (w,
    h), interpolation=cv2.INTER_AREA) does (to fp32 rounding)."""
    H, W = img.shape[:2]
    area = H >= h and W >= w
    wy, wx = _area_weights(H, h, area), _area_weights(W, w, area)
    out = np.einsum("ys,xt,stc->yxc", wy, wx, img.astype(np.float64), optimize=True)
    return out.astype(img.dtype)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[0] == h and img.shape[1] == w:
        return img
    return resize_area(img, h, w)


class RealEstate10K:
    """Map-style wide-baseline dataset over RealEstate10K-format dumps.

    One item = one (context pair, target views) draw from one video:
    context frames `gap` apart (gap ~ U[min_gap, max_gap]), targets
    uniformly inside the context interval (the cross-rendering protocol).
    ACID uses the identical format — point `path` at an ACID dump.
    """

    def __init__(self, cfg: DataConfig, mode: str, full_scale: bool = False,
                 max_len=None, seed=None, min_gap: int = 45, max_gap: int = 135):
        assert cfg.num_input_views == 2, "wide-baseline protocol uses 2 context views"
        self.cfg = cfg
        self.mode = mode
        self.full_scale = full_scale
        self.min_gap, self.max_gap = min_gap, max_gap
        ds = cfg.downsample
        self.h = cfg.height // (2**ds) if ds else cfg.height
        self.w = cfg.width // (2**ds) if ds else cfg.width
        self.coord = make_2dcoord(self.h, self.w)
        stride = 2**cfg.downsample_input_coord
        self.input_coord_ds = self.coord[stride // 2 :: stride, stride // 2 :: stride].reshape(-1, 2)

        split_dir = os.path.join(cfg.path, "train" if mode in ("train", "val") else "test")
        self.split_dir = split_dir
        paths = sorted(glob.glob(os.path.join(split_dir, "*.txt")))
        if mode == "train":
            paths = paths[: 9 * len(paths) // 10]
        elif mode == "val":
            paths = paths[9 * len(paths) // 10 :]
        if max_len is not None:
            paths = paths[:max_len]
        self.camera_paths = paths
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.camera_paths)

    def _frame(self, video_id: str, timestamp: int) -> np.ndarray:
        base = os.path.join(self.split_dir, "frames", video_id, str(timestamp))
        for ext in (".png", ".jpg", ".jpeg"):
            p = base + ext
            if os.path.exists(p):
                img = _imread(p)[..., :3].astype(np.float32) / 255.0
                return _resize(img, self.h, self.w)
        raise FileNotFoundError(base + ".{png,jpg}")

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        rng = np.random.RandomState(
            (self.seed * 1000003 + self.epoch * 7919 + idx) % (1 << 31)
        )
        cam_path = self.camera_paths[idx]
        video_id = os.path.splitext(os.path.basename(cam_path))[0]
        ts, intr, exts = parse_camera_file(cam_path)
        n = len(ts)

        gap = int(rng.randint(self.min_gap, self.max_gap + 1))
        gap = min(gap, n - 1)
        a = int(rng.randint(0, n - gap))
        b = a + gap
        if cfg.reconstruction:
            tgt = np.asarray([a, b])[: cfg.num_target_views]
        else:
            lo, hi = (a + 1, b) if b - a > 1 else (a, b + 1)
            tgt = rng.choice(np.arange(lo, hi), size=cfg.num_target_views,
                             replace=(hi - lo) < cfg.num_target_views)
        frame_idx = np.concatenate([[a, b], np.asarray(tgt, np.int64)])

        exts = normalize_scene_scale(exts, a, b)
        imgs = np.stack([self._frame(video_id, int(ts[i])) for i in frame_idx])
        cam_pos = np.stack([camera_center(exts[i]) for i in frame_idx])
        rays = np.stack(
            [rays_from_intrinsics(exts[i], intr[i], self.w, self.h) for i in frame_idx]
        )
        extrinsics = np.stack([exts[i] for i in frame_idx])

        NI, NT = 2, cfg.num_target_views
        input_sel = np.arange(NI)
        target_sel = np.arange(NI, NI + NT)

        canonical = extrinsics[0].copy()
        if cfg.avoid_zerocamorg:
            canonical[:3, 3] += 0.01
        if cfg.canonical_view:
            rays_c = transform_points(rays, canonical, translate=False)
            pos_c = transform_points(cam_pos, canonical)
            inv_canon = np.linalg.inv(canonical)
            tf = np.stack([extrinsics[i] @ inv_canon for i in range(NI + NT)]).astype(
                np.float32
            )
        else:
            rays_c, pos_c = rays, cam_pos
            tf = extrinsics
        input_tf, target_tf = tf[input_sel], tf[target_sel]

        out = {
            "input_images": imgs[input_sel],
            "input_camera_pos": pos_c[input_sel].astype(np.float32),
            "input_rays": rays_c[input_sel].astype(np.float32),
            "input_transforms": input_tf,
            "transform": canonical.astype(np.float32),
            "sceneid": np.int32(idx),
        }
        HW = self.h * self.w
        tgt_pixels = imgs[target_sel].reshape(NT, HW, 3)

        if not cfg.return_transform:
            t_rays = rays_c[target_sel].reshape(-1, 3).astype(np.float32)
            t_pos = np.repeat(pos_c[target_sel], HW, 0).astype(np.float32)
            t_pix = tgt_pixels.reshape(-1, 3)
            if not self.full_scale:
                sel = rng.choice(len(t_pix), size=cfg.num_points, replace=False)
                t_pix, t_rays, t_pos = t_pix[sel], t_rays[sel], t_pos[sel]
            out.update(
                target_pixels=t_pix.astype(np.float32),
                target_camera_pos=t_pos,
                target_rays=t_rays,
            )
            return out

        base_rays = rays_c[0].reshape(-1, 3).astype(np.float32)
        base_pos = np.broadcast_to(pos_c[0].astype(np.float32), (HW, 3))
        base_coord = self.coord.reshape(-1, 2)
        if not self.full_scale:
            ppv = points_per_view(cfg.num_points, NT)
            px, rs, cp, co = [], [], [], []
            for i in range(NT):
                sel = rng.choice(HW, size=ppv, replace=HW < ppv)
                px.append(tgt_pixels[i, sel])
                rs.append(base_rays[sel])
                cp.append(base_pos[sel])
                co.append(base_coord[sel])
            target_pixels, target_rays = np.stack(px), np.stack(rs)
            target_camera_pos, target_coord = np.stack(cp), np.stack(co)
        else:
            target_pixels = tgt_pixels
            target_rays = np.stack([base_rays] * NT)
            target_camera_pos = np.stack([base_pos] * NT)
            target_coord = np.stack([base_coord] * NT)

        out.update(
            target_pixels=target_pixels.astype(np.float32),
            target_camera_pos=target_camera_pos.astype(np.float32),
            target_rays=target_rays.astype(np.float32),
            target_transforms=target_tf,
            input_coord=np.stack([self.input_coord_ds] * NI),
            target_coord=target_coord.astype(np.float32),
        )
        return out
