"""The port's NeRF sampling and integration utilities
(gta_tpu_torch/geometry/nerf.py) against the JAX package's
(gta_tpu/geometry/nerf.py) on the CPU.

The same numpy rays, histograms and samples go through both: the
deterministic branches (bin midpoints, an even spread of the CDF, the
near-plane clip at min_z) and integrate_ray within 1e-6 of the largest
magnitude compared (fp32, the same formulas; the CDF's cumulative sums
add in another order, a few ulps at depths up to 20). The random
branches draw from a torch.Generator where JAX draws from a key, so they
are held to what holds for any draw: every
stratified depth inside its own bin, every inverse-CDF sample inside the
bin its draw's CDF interval maps to and inside the histogram's support,
and the same generator seed giving the same samples.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.geometry import nerf as jn
from gta_tpu_torch.geometry import nerf as tn

ATOL = 1e-6


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL * max(1.0, float(np.abs(want).max())), rtol=0)


def _rays(rng, n=6):
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    pos[:, 2] = np.abs(pos[:, 2]) + 2.0
    rays = rng.normal(size=(n, 3)).astype(np.float32)
    rays[:, 2] = -np.abs(rays[:, 2]) - 0.1  # towards the z = 0 plane
    return pos, rays / np.linalg.norm(rays, axis=-1, keepdims=True)


@pytest.mark.parametrize("min_z", [None, 0.0])
def test_stratified_deterministic_matches_jax(rng, min_z):
    pos, rays = _rays(rng)
    kw = dict(min_dist=0.5, max_dist=20.0, num_samples=16, min_z=min_z, deterministic=True)
    want = jn.stratified_sample_points(None, jnp.asarray(pos), jnp.asarray(rays), **kw)
    got = tn.stratified_sample_points(None, torch.from_numpy(pos), torch.from_numpy(rays), **kw)
    for a, b in zip(got, want):
        _close(a, b)
    # no generator: the midpoints too
    got = tn.stratified_sample_points(None, torch.from_numpy(pos), torch.from_numpy(rays),
                                      **{**kw, "deterministic": False})
    _close(got[0], want[0])


def _histogram(rng, n=6, s=12):
    bins = np.sort(rng.uniform(0.5, 10.0, size=(n, s + 1)), -1).astype(np.float32)
    weights = rng.uniform(size=(n, s)).astype(np.float32) ** 3
    weights[0, 3:] = 0.0  # a ray whose mass sits in its first bins
    return bins, weights


def test_sample_pdf_deterministic_matches_jax(rng):
    bins, weights = _histogram(rng)
    want = jn.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), 20, deterministic=True)
    got = tn.sample_pdf(None, torch.from_numpy(bins), torch.from_numpy(weights), 20, deterministic=True)
    _close(got, want)


def test_fine_samples_deterministic_match_jax(rng):
    pos, rays = _rays(rng)
    depths = np.sort(rng.uniform(0.5, 10.0, size=(6, 12)), -1).astype(np.float32)
    dist = rng.uniform(size=(6, 12)).astype(np.float32)
    dist /= dist.sum(-1, keepdims=True)
    kw = dict(min_dist=0.2, num_samples=24, deterministic=True)
    want = jn.fine_sample_points(None, *(jnp.asarray(x) for x in (pos, rays, dist, depths)), **kw)
    got = tn.fine_sample_points(None, *(torch.from_numpy(x) for x in (pos, rays, dist, depths)), **kw)
    for a, b in zip(got, want):
        _close(a, b)


def test_integrate_ray_matches_jax(rng):
    depths = np.sort(rng.uniform(0.5, 10.0, size=(4, 5, 16)), -1).astype(np.float32)
    densities = rng.uniform(0.0, 2.0, size=(4, 5, 16)).astype(np.float32)
    values = rng.uniform(size=(4, 5, 16, 3)).astype(np.float32)
    want = jn.integrate_ray(*(jnp.asarray(x) for x in (densities, values, depths)))
    got = tn.integrate_ray(*(torch.from_numpy(x) for x in (densities, values, depths)))
    for a, b in zip(got, want):
        _close(a, b)
    _close(got[2].sum(-1), got[0][..., 3])


def test_random_branches_stay_in_their_bins_and_reproduce(rng):
    pos, rays = _rays(rng)
    tpos, trays = torch.from_numpy(pos), torch.from_numpy(rays)
    kw = dict(min_dist=0.5, max_dist=20.0, num_samples=16, min_z=0.0)
    mid, _ = tn.stratified_sample_points(None, tpos, trays, **kw)
    depths, points = tn.stratified_sample_points(torch.Generator().manual_seed(3), tpos, trays, **kw)
    half = (mid[..., 1] - mid[..., 0])[..., None] / 2  # each ray's bins are even
    assert ((depths >= mid - half - 1e-5) & (depths <= mid + half + 1e-5)).all()
    assert not torch.allclose(depths, mid)
    np.testing.assert_allclose(points.numpy(), (tpos[:, None] + trays[:, None] * depths[..., None]).numpy(), atol=ATOL)
    again, _ = tn.stratified_sample_points(torch.Generator().manual_seed(3), tpos, trays, **kw)
    assert torch.equal(again, depths)

    bins, weights = (torch.from_numpy(x) for x in _histogram(rng))
    samples = tn.sample_pdf(torch.Generator().manual_seed(5), bins, weights, 64)
    assert torch.equal(samples, tn.sample_pdf(torch.Generator().manual_seed(5), bins, weights, 64))
    assert ((samples >= bins[:, :1] - 1e-5) & (samples <= bins[:, -1:] + 1e-5)).all()
    # every sample lies in a bin whose CDF interval holds its draw: inside
    # [bins_i, bins_i+1] for the i its draw selects
    u = torch.rand(samples.shape, generator=torch.Generator().manual_seed(5))
    cdf = torch.cumsum(weights + 1e-5, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf / cdf[:, -1:]], -1)
    i = ((cdf[:, None, :] <= u[..., None]).sum(-1) - 1).clamp(0, bins.shape[-1] - 2)
    lo, hi = bins.gather(-1, i), bins.gather(-1, i + 1)
    assert ((samples >= lo - 1e-5) & (samples <= hi + 1e-5)).all()
    # the ray whose mass sits in its first 3 bins: most samples there
    assert (samples[0] <= bins[0, 3] + 1e-5).float().mean() > 0.9
