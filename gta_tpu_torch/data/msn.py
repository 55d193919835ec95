"""MSN-Hard (MultiShapeNet via Kubric) input pipeline (the JAX package's
gta_tpu/data/msn.py).

Mirrors the reference's sunds/TFDS iterable (multishapenet.py:40-320):
128x128, 10 views/scene, look-at extrinsics derived from the ray grids,
canonicalization in the first input view's frame, per-host sharding with
even-divisibility truncation (so distributed eval reductions never desync,
multishapenet.py:127-138), and the 1M train / 10k test item caps.

The sunds package is optional — construction raises a clear error when it
(or the dataset) is unavailable. `prep_scene` is a pure function over the
raw per-scene arrays so its geometry/sampling logic is unit-testable
without TF data. Host sharding takes torch.distributed's rank and world
size when a process group is initialised (0 and 1 otherwise), where the
JAX package takes its process index and count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data.sampling import points_per_view
from gta_tpu_torch.geometry.coords import make_2dcoord
from gta_tpu_torch.geometry.rays import transform_points


def _downsample(x: np.ndarray, num_steps: int) -> np.ndarray:
    if not num_steps or num_steps < 1:
        return x
    stride = 2**num_steps
    return x[stride // 2 :: stride, stride // 2 :: stride]


def lookat_extrinsic_from_rays(camera_pos: np.ndarray, rays: np.ndarray) -> np.ndarray:
    """Extrinsic from center-pixel mean ray direction (reference nerf.py:7-53,
    rays branch)."""
    h, w = rays.shape[:2]
    center = rays[h // 2 - 1 : h // 2 + 1] if h % 2 == 0 else rays[h // 2 : h // 2 + 1]
    center = center[:, w // 2 - 1 : w // 2 + 1] if w % 2 == 0 else center[:, w // 2 : w // 2 + 1]
    camera_z = center.mean((0, 1))
    camera_z = camera_z / np.linalg.norm(camera_z)
    vertical = np.array((0.0, 0.0, 1.0))
    camera_x = np.cross(camera_z, vertical)
    camera_x = camera_x / np.linalg.norm(camera_x)
    camera_y = np.cross(camera_z, camera_x)
    R = np.stack((camera_x, camera_y, camera_z), -2)
    t = -np.einsum("ij,j->i", R, camera_pos)
    mat = np.concatenate((R, t[:, None]), -1)
    return np.concatenate((mat, np.array([[0.0, 0.0, 0.0, 1.0]])), 0).astype(np.float32)


def prep_scene(
    cfg: DataConfig,
    color: np.ndarray,  # [10, 128, 128, 3] uint8
    ray_origins: np.ndarray,  # [10, 128, 128, 3]
    ray_directions: np.ndarray,  # [10, 128, 128, 3]
    instance_image: Optional[np.ndarray],  # [10, 128, 128, 1] or None
    sceneid: int,
    rng,
    coord: np.ndarray,
    full_scale: bool = False,
) -> dict:
    """Pure per-scene preprocessing (reference multishapenet.py:147-314)."""
    NV = color.shape[0]
    input_views = rng.choice(np.arange(NV), size=cfg.num_input_views, replace=False)
    rest = np.array(sorted(set(range(NV)) - set(input_views)))
    target_views = rng.choice(rest, size=cfg.num_target_views, replace=False)

    color = color.astype(np.float32) / 255.0
    input_images = np.stack([_downsample(color[v], cfg.downsample) for v in input_views])
    input_rays = np.stack([_downsample(ray_directions[v], cfg.downsample) for v in input_views])
    input_camera_pos = ray_origins[input_views][:, 0, 0]  # [N, 3]

    masks = None
    if instance_image is not None:
        idx = instance_image.clip(1, 34) - 1
        masks = np.zeros((NV, *instance_image.shape[1:3], 34), dtype=np.uint8)
        np.put_along_axis(masks, idx, 1, axis=-1)

    ds_ic = (cfg.downsample or 0) + cfg.downsample_input_coord
    input_coord = np.stack(
        [_downsample(coord, ds_ic).reshape(-1, 2)] * len(input_views)
    )

    target_pixels = color[target_views]
    target_rays = ray_directions[target_views]
    target_camera_pos = ray_origins[target_views]

    input_tf = np.stack(
        [
            lookat_extrinsic_from_rays(p, r)
            for p, r in zip(input_camera_pos, input_rays)
        ]
    )
    target_tf = np.stack(
        [
            lookat_extrinsic_from_rays(p[0, 0], r)
            for p, r in zip(target_camera_pos, target_rays)
        ]
    )

    canonical = input_tf[0].copy()
    input_rays = transform_points(input_rays, canonical, translate=False)
    input_camera_pos = transform_points(input_camera_pos, canonical)
    inv_canon = np.linalg.inv(canonical)
    input_tf = np.stack([e @ inv_canon for e in input_tf]).astype(np.float32)
    target_tf = np.stack([e @ inv_canon for e in target_tf]).astype(np.float32)

    if not cfg.return_transform:
        # Non-transform mode (multishapenet.py:270-285): actual target rays.
        t_rays = transform_points(target_rays, canonical, translate=False).reshape(-1, 3)
        t_pos = transform_points(target_camera_pos, canonical).reshape(-1, 3)
        t_pix = target_pixels.reshape(-1, 3)
        if not full_scale:
            sel = rng.choice(len(t_pix), size=cfg.num_points, replace=False)
            t_pix, t_rays, t_pos = t_pix[sel], t_rays[sel], t_pos[sel]
        out = {
            "input_images": input_images.astype(np.float32),
            "input_camera_pos": input_camera_pos.astype(np.float32),
            "input_rays": input_rays.astype(np.float32),
            "target_pixels": t_pix.astype(np.float32),
            "target_camera_pos": t_pos.astype(np.float32),
            "target_rays": t_rays.astype(np.float32),
            "input_transforms": input_tf,
            "transform": canonical.astype(np.float32),
            "sceneid": np.int32(sceneid),
        }
        if masks is not None:
            out["input_masks"] = masks[input_views]
        return out

    h, w = target_pixels.shape[1:3]
    n = h * w
    target_pixels = target_pixels.reshape(-1, n, 3)
    # All views share the canonical ray grid; geometry enters via transforms
    # (reference multishapenet.py:226-231).
    base_rays = input_rays[0]
    input_rays = np.stack([base_rays] * len(input_views)).astype(np.float32)
    base_rays = base_rays.reshape(-1, 3)
    base_pos = np.broadcast_to(input_camera_pos[0], (n, 3))
    base_coord = coord.reshape(-1, 2)

    if not full_scale:
        ppv = points_per_view(cfg.num_points, cfg.num_target_views)
        px, rs, cp, co = [], [], [], []
        for i in range(cfg.num_target_views):
            sel = rng.choice(n, size=ppv, replace=n < ppv)
            px.append(target_pixels[i, sel])
            rs.append(base_rays[sel])
            cp.append(base_pos[sel])
            co.append(base_coord[sel])
        target_pixels = np.stack(px)
        target_rays, target_camera_pos, target_coord = np.stack(rs), np.stack(cp), np.stack(co)
    else:
        target_rays = np.stack([base_rays] * cfg.num_target_views)
        target_camera_pos = np.stack([base_pos] * cfg.num_target_views)
        target_coord = np.stack([base_coord] * cfg.num_target_views)

    out = {
        "input_images": input_images.astype(np.float32),
        "input_camera_pos": input_camera_pos.astype(np.float32),
        "input_rays": input_rays,
        "target_pixels": target_pixels.astype(np.float32),
        "target_camera_pos": target_camera_pos.astype(np.float32),
        "target_rays": target_rays.astype(np.float32),
        "input_transforms": input_tf,
        "target_transforms": target_tf,
        "input_coord": input_coord.astype(np.float32),
        "target_coord": target_coord.astype(np.float32),
        "transform": canonical.astype(np.float32),
        "sceneid": np.int32(sceneid),
    }
    if masks is not None:
        out["input_masks"] = masks[input_views]
    return out


class MultiShapeNet:
    """Iterable MSN-Hard dataset over a sunds/TFDS builder.

    Per-host sharding: shard index = the process's rank, count = the world
    size, with the item count truncated to an even multiple so every
    shard yields the same number of batches (multishapenet.py:127-138).
    """

    H = W = 128

    def __init__(self, cfg: DataConfig, mode: str, full_scale: bool = False,
                 max_len=None, seed=None, shuffle: Optional[int] = None):
        self.cfg = cfg
        self.mode = mode
        self.full_scale = full_scale
        self.coord = make_2dcoord(self.H, self.W)
        self.render_kwargs = {"min_dist": 0.0, "max_dist": 20.0}
        self.seed = 0 if seed is None else int(seed)
        self.shuffle = shuffle
        self._skip = 0
        self.prep_workers = 4

        try:
            import sunds  # noqa: F401
            import tensorflow as tf
        except ImportError as e:
            raise RuntimeError(
                "MSN-Hard requires the `sunds` package (TFDS multi_shapenet). "
                "Install it and point data.path at the dataset directory."
            ) from e

        tf.config.set_visible_devices([], "GPU")
        builder = sunds.builder("multi_shapenet", data_dir=cfg.path)
        self.tf_dataset = builder.as_dataset(
            split=mode,
            task=sunds.tasks.Nerf(
                yield_mode="stacked", additional_camera_specs={"instance_image"}
            ),
        )
        self.num_items = 1_000_000 if mode == "train" else 10_000
        if max_len is not None:
            self.num_items = min(max_len, self.num_items)
        self.tf_dataset = self.tf_dataset.take(self.num_items)

    def __len__(self):
        return self.num_items

    def skip(self, n: int):
        """Skip the first n scenes of this host's stream on the next
        iteration — stream-position resume (reference multishapenet.py:
        316-320, which the reference never wires into training; train.py
        here calls it on checkpoint restore)."""
        self._skip += int(n)

    def _prep(self, i: int, data: dict) -> dict:
        # per-item rng keyed on (seed, stream position): deterministic and
        # safe under the parallel prep pool
        rng = np.random.RandomState((self.seed * 1000003 + i) % (1 << 31))
        return prep_scene(
            self.cfg,
            data["color_image"],
            data["ray_origins"],
            data["ray_directions"],
            data.get("instance_image"),
            int(data["scene_name"][6:]),
            rng,
            self.coord,
            self.full_scale,
        )

    def __iter__(self):
        import collections
        from concurrent.futures import ThreadPoolExecutor

        import torch.distributed as dist

        distributed = dist.is_available() and dist.is_initialized()
        n_shard = dist.get_world_size() if distributed else 1
        index = dist.get_rank() if distributed else 0
        ds = self.tf_dataset
        if n_shard > 1:
            shardable = (self.num_items // n_shard) * n_shard
            if shardable != self.num_items:
                ds = ds.take(shardable)
            ds = ds.shard(num_shards=n_shard, index=index)
        # Stream-position resume applies to the FIRST epoch after the
        # restore only; later epochs must replay the full shard (consuming
        # the skip here resets it).
        skip, self._skip = self._skip, 0
        if skip:
            ds = ds.skip(skip)
        if self.shuffle and self.mode == "train":
            ds = ds.shuffle(self.shuffle)

        # Parallel prep_scene over a bounded in-flight window (in stream
        # order): the numpy geometry/sampling work is the per-item cost and
        # would otherwise starve the device — the analogue of the
        # reference's world_size x num_workers loader parallelism
        # (multishapenet.py:110-138) within one host process.
        start = skip
        with ThreadPoolExecutor(self.prep_workers) as pool:
            window: collections.deque = collections.deque()
            for i, data in enumerate(ds.as_numpy_iterator()):
                window.append(pool.submit(self._prep, start + i, data))
                if len(window) >= 2 * self.prep_workers:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()
