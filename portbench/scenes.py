"""The benchmark's scenes, made on the device from the seed.

A scene is 3-6 shaded spheres in a box, seen by cameras on a shell of
radius 7-10 at elevations 0.25-0.9 that look at the origin, ray-traced at
the config's resolution (the arithmetic of the port's synthetic data,
`gta_tpu_torch/data/device_synth.py`, rewritten with a seeded
`torch.Generator` on the device in place of its counter hash). Each scene
has its input views, its target views and one further camera for a novel
view; everything is expressed in the frame of the first input view, as the
MSN and CLEVR-TR readers canonicalise it.

`make_scenes` returns a dict of plain tensors (the fields of the program's
`SceneBatch`, under the same names), which the harness hands to the program
and the reference alike. Every seed gives the same sizes; only the values
differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import rigid_inverse

MAX_SPHERES = 6
LIGHT = (0.4, 0.3, 0.85)
BG = (0.6, 0.7, 1.0)


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device` for the draws of purpose `salt` of a run."""
    lo, hi = np.random.SeedSequence([seed, salt]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(lo) | (int(hi) << 32))
    return g


def lookat(pos: torch.Tensor) -> torch.Tensor:
    """World-to-camera extrinsics [..., 4, 4] of level cameras at `pos`
    looking at the origin: rows right, down, forward."""
    z = -pos / torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    up = torch.zeros_like(z)
    up[..., 2] = 1.0
    x = torch.linalg.cross(z, up)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    R = torch.stack((x, torch.linalg.cross(z, x), z), -2)
    E = torch.zeros((*pos.shape[:-1], 4, 4), device=pos.device)
    E[..., :3, :3] = R
    E[..., :3, 3] = -torch.einsum("...ij,...j->...i", R, pos)
    E[..., 3, 3] = 1.0
    return E


def pixel_dirs(h: int, w: int, device, focal: float = 0.035, sensor_width: float = 0.032) -> torch.Tensor:
    """Camera-frame unit directions [h, w, 3] through the pixel centres."""
    sensor_height = sensor_width / w * h
    u = (torch.arange(w, dtype=torch.float64) + 0.5) / w * 2 - 1
    v = (torch.arange(h, dtype=torch.float64) + 0.5) / h * 2 - 1
    vv, uu = torch.meshgrid(v * sensor_height / 2, u * sensor_width / 2, indexing="ij")
    d = torch.stack([uu, vv, torch.full_like(uu, focal)], -1)
    return (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).float().to(device)


def shade(pos, rays, centres, radii, colours) -> torch.Tensor:
    """Ray-traced spheres on a sky gradient: pos [B, V, 3], rays
    [B, V, H, W, 3], spheres [B, K, ...] (radius 0: absent) -> [B, V, H, W, 3]."""
    oc = (pos[:, :, None, :] - centres[:, None])[:, :, :, None, None, :]  # [B, V, K, 1, 1, 3]
    d = rays[:, :, None]  # [B, V, 1, H, W, 3]
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radii[:, None, :, None, None] ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc > 0) & (t > 1e-3), t, math.inf)
    t_near, k_near = t.min(2)  # [B, V, H, W]
    hit = torch.isfinite(t_near)
    p = pos[:, :, None, None] + rays * torch.where(hit, t_near, 1.0)[..., None]
    idx = k_near[..., None].expand(*k_near.shape, 3)
    B, V = pos.shape[:2]
    cen = torch.gather(centres[:, None, None, None].expand(B, V, *k_near.shape[2:], MAX_SPHERES, 3), -2,
                       idx[..., None, :]).squeeze(-2)
    col = torch.gather(colours[:, None, None, None].expand(B, V, *k_near.shape[2:], MAX_SPHERES, 3), -2,
                       idx[..., None, :]).squeeze(-2)
    n = p - cen
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-8)
    light = torch.tensor(LIGHT, device=pos.device)
    light = light / torch.linalg.vector_norm(light)
    obj = col * (0.35 + 0.65 * torch.clamp((n * light).sum(-1), 0.0, 1.0))[..., None]
    sky = 0.5 + 0.4 * rays[..., 2:3] * torch.tensor(BG, device=pos.device)
    return torch.clamp(torch.where(hit[..., None], obj, sky), 0.0, 1.0)


def make_scenes(sizes: dict, count: int, seed: int, salt: int, device, chunk: int = 16) -> dict:
    """`count` scenes of a config's `sizes["data"]`, drawn from (seed, salt)
    on `device`: the fields of a training batch (input views, target rays
    sampled `num_points / num_target_views` to a target view without
    replacement, their pixels) and `novel` [count, 4, 4], a further
    camera relative to the first input view. With `return_transform` the
    targets come as the transform-mode batch (the first input view's ray
    grid at the sampled pixels, each target view's transform, the pixel
    coordinates); without it, as each target view's own rays, flattened."""
    d = sizes["data"]
    NI, NT, H, W = d["num_input_views"], d["num_target_views"], d["height"], d["width"]
    V, P = NI + NT + 1, d["num_points"] // NT
    g = generator(seed, salt, device)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)  # noqa: E731
    dirs = pixel_dirs(H, W, device)
    i, j = torch.meshgrid(torch.arange(H, device=device) / H, torch.arange(W, device=device) / W, indexing="ij")
    coord = torch.stack([i, j], -1).float().reshape(-1, 2)
    stride = d["input_coord_stride"]
    in_coord = torch.stack([i, j], -1).float()[stride // 2::stride, stride // 2::stride].reshape(-1, 2)
    out = {}
    for c0 in range(0, count, chunk):
        B = min(chunk, count - c0)
        n = 3 + (u(B, 1) * 4).long()
        centres = u(B, MAX_SPHERES, 3) * torch.tensor([6.0, 6.0, 1.5], device=device) + torch.tensor(
            [-3.0, -3.0, 0.3], device=device)
        radii = torch.where(torch.arange(MAX_SPHERES, device=device) < n, 0.4 + 0.7 * u(B, MAX_SPHERES), 0.0)
        colours = 0.1 + 0.9 * u(B, MAX_SPHERES, 3)
        az, el, r = 2 * math.pi * u(B, V), 0.25 + 0.65 * u(B, V), 7.0 + 3.0 * u(B, V)
        pos = torch.stack([r * torch.cos(az) * torch.cos(el), r * torch.sin(az) * torch.cos(el), r * torch.sin(el)], -1)
        E = lookat(pos)  # [B, V, 4, 4]
        rays = torch.einsum("hwc,bvck->bvhwk", dirs, E[..., :3, :3])
        images = shade(pos, rays, centres, radii, colours)
        canon = E[:, 0]
        Rc = canon[:, :3, :3]
        rays_c = torch.einsum("bij,bvhwj->bvhwi", Rc, rays)
        pos_c = torch.einsum("bij,bvj->bvi", Rc, pos) + canon[:, None, :3, 3]
        rel = E @ rigid_inverse(canon)[:, None]
        sel = torch.argsort(u(B, NT, H * W), -1)[..., :P]  # [B, NT, P]
        rows = torch.arange(B, device=device)[:, None, None]
        views = torch.arange(NI, NI + NT, device=device)[None, :, None]
        t_pix = images.reshape(B, V, H * W, 3)[rows, views, sel]
        part = {"input_images": images[:, :NI], "input_camera_pos": pos_c[:, :NI], "input_rays": rays_c[:, :NI],
                "input_transforms": rel[:, :NI], "target_pixels": t_pix, "novel": rel[:, -1]}
        if d["return_transform"]:
            base = rays_c[:, 0].reshape(B, H * W, 3)
            part.update(target_rays=base[torch.arange(B, device=device)[:, None, None], sel],
                        target_camera_pos=pos_c[:, 0][:, None, None].expand(B, NT, P, 3).contiguous(),
                        target_transforms=rel[:, NI:NI + NT], target_coord=coord[sel],
                        input_coord=in_coord.expand(B, NI, *in_coord.shape).contiguous())
        else:
            t_rays = rays_c.reshape(B, V, H * W, 3)[rows, views, sel]
            part.update(target_pixels=t_pix.reshape(B, NT * P, 3), target_rays=t_rays.reshape(B, NT * P, 3),
                        target_camera_pos=pos_c[:, NI:NI + NT][:, :, None].expand(B, NT, P, 3).reshape(B, NT * P, 3))
        for k, v in part.items():
            out.setdefault(k, []).append(v.contiguous())
    return {k: torch.cat(v) for k, v in out.items()}


def rows(scenes: dict, index) -> dict:
    """The scenes at `index` (a slice or index tensor)."""
    return {k: v[index] for k, v in scenes.items()}
