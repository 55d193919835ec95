"""Volumetric (NeRF-style) sampling and integration utilities.

Port of gta_tpu/geometry/nerf.py (the reference's sampling stack,
nerf.py:247-427): stratified coarse samples, inverse-CDF fine sampling and
alpha-composited integration. The SRT-family models are light fields (one
MLP evaluation per ray) and no shipped config runs these; they are here for
parity of capability with the JAX package. Each function runs on the device
of its inputs. Where JAX takes a PRNG key, these take an explicit
`torch.Generator` (on the inputs' device); without one, or with
`deterministic=True`, they take the bins' midpoints (stratified) and an
even spread of the CDF (fine). The batched search is a count of CDF entries
at or below each draw, as the JAX package's is, so no boolean indexing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _uniform(shape, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


def stratified_sample_points(
    generator: Optional[torch.Generator],
    camera_pos: torch.Tensor,
    rays: torch.Tensor,
    min_dist: float = 0.035,
    max_dist: float = 30.0,
    num_samples: int = 256,
    min_z: Optional[float] = None,
    deterministic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse depths and 3D points along each ray: camera_pos, rays [..., 3]
    -> (depths [..., S], points [..., S, 3]). One depth per bin of an even
    split of [min_dist, far]: the bin's midpoint, or a uniform draw inside
    it. min_z clips the far plane at the ray's crossing of the plane
    z = min_z (reference nerf.py:247-292)."""
    far = torch.full_like(rays[..., 0], max_dist)
    if min_z is not None:
        t_int = (min_z - camera_pos[..., 2]) / rays[..., 2]
        hit = (t_int >= 0.0) & (t_int <= far)
        far = torch.where(hit, t_int, far)
    borders = torch.linspace(0.0, 1.0, num_samples + 1, dtype=rays.dtype, device=rays.device)
    borders = borders * (far[..., None] - min_dist) + min_dist  # [..., S+1]
    lo, hi = borders[..., :-1], borders[..., 1:]
    if deterministic or generator is None:
        depths = 0.5 * (hi + lo)
    else:
        depths = lo + _uniform(hi.shape, hi, generator) * (hi - lo)
    points = camera_pos[..., None, :] + rays[..., None, :] * depths[..., None]
    return depths, points


def sample_pdf(
    generator: Optional[torch.Generator],
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    deterministic: bool = False,
) -> torch.Tensor:
    """Inverse-CDF samples from a depth histogram: bins [..., S+1], weights
    [..., S] -> [..., num_samples] (reference nerf.py:331-370)."""
    weights = weights + 1e-5
    cdf = torch.cumsum(weights, -1)
    cdf = cdf / cdf[..., -1:]
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [..., S+1]
    shape = (*bins.shape[:-1], num_samples)
    if deterministic or generator is None:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype, device=cdf.device).expand(shape)
    else:
        u = _uniform(shape, cdf, generator)
    # batched searchsorted(side='right'): the count of cdf entries <= u
    inds = (cdf[..., None, :] <= u[..., :, None]).sum(-1)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    last = bins.shape[-1] - 1
    bins_b, bins_a = bins.gather(-1, below.clamp(max=last)), bins.gather(-1, above.clamp(max=last))
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a), cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def fine_sample_points(
    generator: Optional[torch.Generator],
    camera_pos: torch.Tensor,
    rays: torch.Tensor,
    depth_dist: torch.Tensor,
    depths: torch.Tensor,
    min_dist: float = 0.035,
    num_samples: int = 256,
    deterministic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine samples around a coarse depth distribution depth_dist [..., S]
    (summing to 1) at depths [..., S] (reference nerf.py:295-328): each
    coarse sample gives 75% of its mass to the segment before it and 25% to
    the one after. Returns (depths [..., num_samples], points [...,
    num_samples, 3])."""
    borders = torch.cat(
        [
            torch.full_like(depths[..., :1], min_dist),
            depths,
            1.5 * depths[..., -1:] - 0.5 * depths[..., -2:-1],
        ],
        -1,
    )  # [..., S+2]
    hist = torch.zeros_like(borders[..., 1:])
    hist[..., :-1] += depth_dist * 0.75
    hist[..., 1:] += depth_dist * 0.25
    sample_depths = sample_pdf(generator, borders, hist, num_samples, deterministic)
    points = camera_pos[..., None, :] + rays[..., None, :] * sample_depths[..., None]
    return sample_depths, points


def integrate_ray(
    densities: torch.Tensor,
    values: torch.Tensor,
    depths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alpha-composite samples along rays (reference draw_nerf, nerf.py:
    373-427): densities [..., S], values [..., S, 3], depths [..., S] ->
    (rgba [..., 4], expected depth [...], segment probabilities [..., S])."""
    seg = depths[..., 1:] - depths[..., :-1]
    seg = torch.cat([seg, torch.full_like(seg[..., -1:], 1e10)], -1)
    p_empty = torch.exp(-densities * seg)
    alpha = 1.0 - p_empty
    ray_empty = torch.cumprod(p_empty + 1e-10, -1)
    ray_empty_shift = torch.cat([torch.ones_like(ray_empty[..., :1]), ray_empty[..., :-1]], -1)
    seg_probs = alpha * ray_empty_shift
    total_alpha = 1.0 - ray_empty[..., -1]
    rgb = (values * seg_probs[..., None]).sum(-2)
    expected_depth = (seg_probs * depths).sum(-1)
    rgba = torch.cat([rgb, total_alpha[..., None]], -1)
    return rgba, expected_depth, seg_probs
