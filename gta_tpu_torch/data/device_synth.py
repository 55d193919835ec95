"""Synthetic scenes made on the device, batch by batch.

Port of gta_tpu/data/device_synth.py. The host pipeline (data/synthetic.py)
renders every scene on the CPU and copies it to the card; here the whole
scene pipeline runs as torch ops on the generator's device: sphere and
camera draws, ray-traced shading, the input/target split, canonicalisation
to the first input view and pixel sampling (reference clevr_tr.py:234-327),
so a train step takes freshly made scenes with no host work and no copy.

The scene distribution is data/synthetic.py's (the same sphere, camera and
shading parameters). The draws come from a counter-based hash rather than
a generator: every random value is an integer mix of (seed, mode, scene
id, stream, index), so a scene depends on those alone, not on the batch it
lands in, on the rank that makes it, on a resume or on the device, and the
integer draws (sphere counts, permutations, sampled pixels) are the same
bits on the CPU and on the card. Nothing in `batch` reads a value back to
the host.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data.sampling import points_per_view
from gta_tpu_torch.geometry.coords import make_2dcoord
from gta_tpu_torch.models.context import SceneBatch

MAX_SPHERES = 6
MASK32 = 0xFFFFFFFF
MODE_BASE = {"train": 0, "val": 1 << 20, "test": 1 << 21}
EVAL_CYCLE = 1 << 18  # val / test ids cycle this range above their base


def hash32(x):
    """A 32-bit integer mix (two multiply-xorshift rounds, constants below
    2^31 so no product leaves int64) of values in [0, 2^32): Python ints or
    int64 tensors alike, the same bits on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & MASK32
    return x ^ (x >> 15)


def stream_key(seed: int, salt: int) -> int:
    """The generator's base key: seed (any int) folded with a salt."""
    seed &= (1 << 64) - 1
    return hash32(hash32(hash32(seed & MASK32) ^ (seed >> 32)) ^ (salt & MASK32))


def scene_keys(key: int, ids: torch.Tensor) -> torch.Tensor:
    """Per-scene keys [B] of int64 scene ids (>= 0)."""
    return hash32(hash32(key ^ (ids & MASK32)) ^ (ids >> 32))


def draw_bits(keys: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """[B, n] 32-bit draws (int64) of stream `stream` of each scene."""
    s = hash32(keys ^ stream)
    index = torch.arange(n, dtype=torch.int64, device=keys.device)
    return hash32(hash32(s[:, None] ^ index))


def to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) from 32-bit draws: the top 24 bits, exact in fp32."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(keys, stream, n, lo=0.0, hi=1.0) -> torch.Tensor:
    return to_uniform(draw_bits(keys, stream, n)) * (hi - lo) + lo


def sort_keys(bits: torch.Tensor) -> torch.Tensor:
    """Distinct sort keys from draws along the last axis: the draw above
    the index, so ties are impossible and every device orders alike."""
    n = bits.shape[-1]
    index = torch.arange(n, dtype=torch.int64, device=bits.device)
    return (bits << max(1, (n - 1).bit_length())) | index


def permutation(keys, stream, n) -> torch.Tensor:
    """[B, n] a random permutation of range(n) per scene."""
    return torch.argsort(sort_keys(draw_bits(keys, stream, n)), dim=-1)


def choice_without_replacement(bits: torch.Tensor, k: int) -> torch.Tensor:
    """k of the last axis's indices, without replacement, from its draws."""
    return torch.topk(sort_keys(bits), k, dim=-1, largest=False, sorted=True).indices


def lookat_extrinsic(camera_pos: torch.Tensor) -> torch.Tensor:
    """World->camera extrinsics [..., 4, 4] of level cameras looking at the
    origin (geometry/rays.lookat_extrinsic, reference nerf.py:7-53)."""
    z = -camera_pos
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    vertical = torch.zeros_like(z)
    vertical[..., 2].fill_(1.0)
    x = torch.linalg.cross(z, vertical)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    R = torch.stack((x, y, z), -2)  # rows: right, down-y, forward
    t = -torch.einsum("...ij,...j->...i", R, camera_pos)
    bottom = camera_pos.new_zeros((*camera_pos.shape[:-1], 1, 4))
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat((torch.cat((R, t[..., None]), -1), bottom), -2)


def inv_se3(mat: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of [..., 4, 4] rigid transforms (R^T, -R^T t)."""
    Rt = mat[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, mat[..., :3, 3])
    out = torch.zeros_like(mat)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = ti
    out[..., 3, 3].fill_(1.0)
    return out


def pixel_dirs(h: int, w: int, focal: float = 0.035, sensor_width: float = 0.032) -> np.ndarray:
    """Constant camera-frame pixel directions [H, W, 3], unit norm, float32:
    geometry/rays.camera_rays_from_extrinsic's pixel centres (world rays are
    then d @ R, R the extrinsic's rows right / down-y / forward)."""
    sensor_height = (sensor_width / w) * h
    hb = np.linspace(-1, 1, w + 1) * sensor_width / 2
    vb = np.linspace(-1, 1, h + 1) * sensor_height / 2
    hh, vv = np.meshgrid((hb[:-1] + hb[1:]) / 2, (vb[:-1] + vb[1:]) / 2)
    d = np.stack([hh, vv, np.full_like(hh, focal)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(np.float32)


_LIGHT = np.asarray([0.4, 0.3, 0.85]) / np.linalg.norm([0.4, 0.3, 0.85])
_BG = (0.6, 0.7, 1.0)


def render_spheres(camera_pos, rays, centers, radii, colors, light=None, bg_tint=None) -> torch.Tensor:
    """Ray-traced shaded spheres on a gradient background
    (data/synthetic._render); a radius-0 sphere never hits, so padding
    masks absent spheres.

    camera_pos [..., 3], rays [..., H, W, 3], centers [..., K, 3], radii
    [..., K], colors [..., K, 3] (leading dims broadcast); `light` and
    `bg_tint` are the constants _LIGHT and _BG as tensors on the rays'
    device (made here when not given). Returns [..., H, W, 3] float32 in
    [0, 1].
    """
    oc = (camera_pos[..., None, :] - centers)[..., None, None, :]  # [..., K, 1, 1, 3]
    d = rays[..., None, :, :, :]  # [..., 1, H, W, 3]
    b = torch.sum(oc * d, -1)  # [..., K, H, W]
    c = torch.sum(oc * oc, -1) - radii[..., None, None] ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc > 0) & (t > 1e-3), t, math.inf)
    t_near, k_near = torch.min(t, -3)  # [..., H, W]
    hit_any = torch.isfinite(t_near)

    t_fin = torch.where(hit_any, t_near, 1.0)
    p = camera_pos[..., None, None, :] + rays * t_fin[..., None]
    # a gather by the nearest sphere (the TPU contracts a one-hot instead:
    # its gathers are slow; the pixels are the same)
    lead = k_near.shape[:-2]
    flat = k_near.reshape(*lead, -1, 1).expand(*lead, k_near.shape[-2] * k_near.shape[-1], 3)
    near_c = torch.gather(centers.expand(*lead, *centers.shape[-2:]), -2, flat).reshape(p.shape)
    near_col = torch.gather(colors.expand(*lead, *colors.shape[-2:]), -2, flat).reshape(p.shape)
    n = p - near_c
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-8)
    light = n.new_tensor(_LIGHT) if light is None else light
    shade = 0.35 + 0.65 * torch.clamp(torch.sum(n * light, -1), 0.0, 1.0)
    obj = near_col * shade[..., None]
    bg_tint = n.new_tensor(_BG) if bg_tint is None else bg_tint
    bg = 0.5 + 0.4 * rays[..., 2:3] * bg_tint
    img = torch.where(hit_any[..., None], obj, bg)
    return torch.clamp(img, 0.0, 1.0).to(torch.float32)



class DeviceSynthetic:
    """Batches of synthetic CLEVR-TR-shaped scenes made on `device` (CUDA
    unless the caller asks for the CPU), in SyntheticScenes' batch layout.

        gen = DeviceSynthetic(cfg.data, "train", seed=cfg.seed)
        batch = gen.batch(step, batch_size)

    Train mode streams fresh scene ids forever (they advance with `step`);
    val and test modes cycle a fixed range of ids above their own base, so
    every evaluation sees the same scenes.
    """

    def __init__(self, cfg: DataConfig, mode: str = "train", seed: int = 0, full_scale: bool = False,
                 device: Optional[str] = None):
        from gta_tpu_torch.train.trainer import resolve_device

        self.cfg = cfg
        self.mode = mode
        self.full_scale = full_scale
        self.device = resolve_device(device)
        self.id_base = MODE_BASE[mode]
        self.key = stream_key(seed, self.id_base + 17)
        ds = cfg.downsample
        self.h = cfg.height // (2**ds) if ds else cfg.height
        self.w = cfg.width // (2**ds) if ds else cfg.width
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        self.dirs = put(pixel_dirs(self.h, self.w))
        coord2d = make_2dcoord(self.h, self.w)
        self.coord = put(coord2d.reshape(-1, 2))
        stride = 2**cfg.downsample_input_coord
        self.input_coord_ds = put(coord2d[stride // 2 :: stride, stride // 2 :: stride].reshape(-1, 2))
        self.center_lo = put(np.asarray([-3.0, -3.0, 0.3], np.float32))
        self.center_span = put(np.asarray([6.0, 6.0, 1.5], np.float32))
        self.sphere_slot = torch.arange(MAX_SPHERES, device=self.device)
        self.light, self.bg_tint = put(_LIGHT.astype(np.float32)), put(np.asarray(_BG, np.float32))
        offset = np.zeros((4, 4), np.float32)
        offset[:3, 3] = 0.01
        self.zerocamorg_offset = put(offset)

    # ------------------------------------------------------------------
    def ids(self, step: int, batch_size: int, shard_index: int = 0, shard_count: int = 1) -> torch.Tensor:
        """The scene ids of batch `step` of this shard: rank r of R at step s
        takes rows [r * B, (r + 1) * B) of the global batch s of R * B."""
        start = (step * shard_count + shard_index) * batch_size
        if self.mode != "train":
            start %= EVAL_CYCLE
        return torch.arange(start, start + batch_size, dtype=torch.int64, device=self.device) + self.id_base

    def batch(self, step: int, batch_size: int, shard_index: int = 0, shard_count: int = 1) -> SceneBatch:
        """Batch `step` (train: fresh ids forever; val / test: a fixed id
        range, cycled), as a SceneBatch of tensors on the device. A
        multi-rank run passes its rank and world size, so that ranks take
        disjoint ids whose union is one rank's batch of world x B."""
        return self.scenes(self.ids(step, batch_size, shard_index, shard_count))

    def val_batches(self, num_scenes: int, batch_size: int) -> List[SceneBatch]:
        """The fixed evaluation set: max(1, num_scenes // batch_size) batches."""
        return [self.batch(i, batch_size) for i in range(max(1, num_scenes // batch_size))]

    # ------------------------------------------------------------------
    def draws(self, keys: torch.Tensor):
        """The scenes' spheres and cameras from their keys (`scene_keys`):
        centers [B, 6, 3], radii [B, 6] (0 past the scene's 3-6 spheres),
        colors [B, 6, 3] and world camera positions [B, num_views, 3] on the
        shell of radius 7-10 at elevations 0.25-0.9, as data/synthetic.py
        draws them."""
        B, NV = keys.shape[0], self.cfg.num_views
        n = 3 + (draw_bits(keys, 0, 1) >> 30)  # [B, 1]: 3..6 spheres
        centers = uniform(keys, 1, MAX_SPHERES * 3).view(B, MAX_SPHERES, 3) * self.center_span + self.center_lo
        radii = torch.where(self.sphere_slot < n, uniform(keys, 2, MAX_SPHERES, 0.4, 1.1), 0.0)
        colors = uniform(keys, 3, MAX_SPHERES * 3, 0.1, 1.0).view(B, MAX_SPHERES, 3)
        az = uniform(keys, 4, NV, 0.0, 2 * math.pi)
        el = uniform(keys, 5, NV, 0.25, 0.9)
        r = uniform(keys, 6, NV, 7.0, 10.0)
        cam_pos = torch.stack([r * torch.cos(az) * torch.cos(el), r * torch.sin(az) * torch.cos(el),
                               r * torch.sin(el)], -1)
        return centers, radii, colors, cam_pos

    def scenes(self, ids: torch.Tensor) -> SceneBatch:
        """The scenes of the given ids (int64 [B] on the device, id_base
        included), each made from its own draws alone."""
        cfg = self.cfg
        NV, NI, NT = cfg.num_views, cfg.num_input_views, cfg.num_target_views
        B, HW = ids.shape[0], self.h * self.w
        keys = scene_keys(self.key, ids)
        rows = torch.arange(B, device=self.device)[:, None]
        centers, radii, colors, cam_pos = self.draws(keys)
        ext = lookat_extrinsic(cam_pos)  # [B, NV, 4, 4]
        # world rays: the camera-frame directions times the rotation's rows
        all_rays = torch.einsum("hwc,bvck->bvhwk", self.dirs, ext[..., :3, :3])
        imgs = render_spheres(cam_pos, all_rays, centers[:, None], radii[:, None], colors[:, None], self.light,
                              self.bg_tint)

        perm = permutation(keys, 7, NV)
        input_idx = perm[:, :NI]
        if cfg.reconstruction:
            target_idx = input_idx[:, :NT]
        elif cfg.overlap:
            target_idx = permutation(keys, 8, NV)[:, :NT]
        else:
            target_idx = perm[:, NI:NI + NT]

        canon = ext[rows[:, 0], input_idx[:, 0]]  # [B, 4, 4]
        if cfg.avoid_zerocamorg:
            canon = canon + self.zerocamorg_offset
        if cfg.canonical_view:
            Rc = canon[:, :3, :3]
            rays_c = torch.einsum("bij,bvhwj->bvhwi", Rc, all_rays)
            pos_c = torch.einsum("bij,bvj->bvi", Rc, cam_pos) + canon[:, None, :3, 3]
            inv_canon = inv_se3(canon)[:, None]
            input_tf = ext[rows, input_idx] @ inv_canon
            target_tf = ext[rows, target_idx] @ inv_canon
        else:
            rays_c, pos_c = all_rays, cam_pos
            input_tf = ext[rows, input_idx]
            target_tf = ext[rows, target_idx]

        out = dict(
            input_images=imgs[rows, input_idx],
            input_camera_pos=pos_c[rows, input_idx],
            input_rays=rays_c[rows, input_idx],
            input_transforms=input_tf,
            transform=canon,
            sceneid=ids.to(torch.int32),
        )

        if not cfg.return_transform:
            # non-transform mode (clevr_tr.py:313-327): the target views' own
            # rays, flattened over the views
            t_rays = rays_c[rows, target_idx].reshape(B, NT * HW, 3)
            t_pos = pos_c[rows, target_idx][:, :, None].expand(B, NT, HW, 3).reshape(B, NT * HW, 3)
            t_pix = imgs[rows, target_idx].reshape(B, NT * HW, 3)
            if not self.full_scale:
                sel = choice_without_replacement(draw_bits(keys, 9, NT * HW), cfg.num_points)  # [B, P]
                t_pix, t_rays, t_pos = t_pix[rows, sel], t_rays[rows, sel], t_pos[rows, sel]
            return SceneBatch(**out, target_pixels=t_pix, target_camera_pos=t_pos, target_rays=t_rays)

        # transform mode: the canonical view-0 ray grid for every target;
        # the relative transform carries the view change (clevr_tr.py:275-311)
        base_rays = out["input_rays"][:, 0].reshape(B, HW, 3)
        base_pos = out["input_camera_pos"][:, 0]  # [B, 3]
        tgt_imgs = imgs[rows, target_idx].reshape(B, NT, HW, 3)
        if not self.full_scale:
            ppv = points_per_view(cfg.num_points, NT)
            bits = draw_bits(keys, 9, NT * (ppv if HW < ppv else HW)).view(B, NT, -1)
            # with replacement only where a view has fewer pixels than draws
            sel = (bits * HW) >> 32 if HW < ppv else choice_without_replacement(bits, ppv)  # [B, NT, ppv]
            target_pixels = tgt_imgs[rows[..., None], torch.arange(NT, device=self.device)[:, None], sel]
            target_rays = base_rays[rows[..., None], sel]
            target_coord = self.coord[sel]
        else:
            ppv = HW
            target_pixels = tgt_imgs
            target_rays = base_rays[:, None].expand(B, NT, HW, 3).contiguous()
            target_coord = self.coord.expand(B, NT, HW, 2).contiguous()
        return SceneBatch(
            **out,
            target_pixels=target_pixels,
            target_camera_pos=base_pos[:, None, None].expand(B, NT, ppv, 3).contiguous(),
            target_rays=target_rays,
            target_transforms=target_tf,
            input_coord=self.input_coord_ds.expand(B, NI, *self.input_coord_ds.shape).contiguous(),
            target_coord=target_coord,
        )
