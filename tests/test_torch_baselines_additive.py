"""The baselines that condition q, k, v additively or by FiLM, or append
learned rep vectors, in the port against the JAX package on the CPU:
APE (`ape`), MLN / FiLM (`mln`), frustum positional embeddings
(`frustum_posemb_dmax20`) and RPE (`rpe`, method `invatt_directsum`), each
shrunk and held as tests/test_torch_gta_ablations.py holds its configs
(eval_step pixels within 1e-4, one step's gradients within 5e-5 / rtol
1e-3); and their geometry: the fixed-grid and coordinate 2D positional
encodings, the frustum points, the Plücker parameters, distances and
encodings (gbt), the T(2) matrices and the per-ray rotation frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.geometry import coords as jcoords, frustum as jfrustum, plucker as jplucker, rays as jrays, t2 as jt2
from gta_tpu_torch.geometry import coords, frustum, plucker, rays, t2
from gta_tpu_torch.models.layers import Attention
from tests.conftest import random_se3
from tests.test_torch_gta_ablations import check_config


@pytest.mark.parametrize("path", [
    "runs/clevrtr/otherPEs/ape/config.yaml",
    "runs/clevrtr/otherPEs/mln/config.yaml",
    "runs/clevrtr/otherPEs/frustum_posemb_dmax20/config.yaml",
    "runs/clevrtr/otherPEs/rpe/config.yaml",
], ids=["ape", "mln", "frustum_posemb", "rpe"])
def test_baseline_matches_jax(path):
    ttr = check_config(path)
    enc, dec = ttr.model.encoder, ttr.model.decoder
    method = enc.cfg.attn.method
    layer = enc.transformer.layers[0][0].fn
    if method in ("ape", "mln"):
        # the adjustable softmax's temperature, under the reference's key
        assert "encoder.transformer.layers.0.0.fn.attend.tau" in dict(ttr.model.named_parameters())
    if method == "frustum_posemb":
        assert enc.frustum_phi[0].in_features == 4 * enc.cfg.attn.frustum_D
        assert not hasattr(dec.allocation_transformer, "input_mlp")
    if method == "invatt_directsum":
        # to_out takes the rep vectors appended to each head: 16 + 4 so2
        rdim = 16 + 4 * enc.cfg.attn.rpe_so2
        assert layer.q_bias.shape == (2, rdim)
        assert layer.to_out[0].in_features == 2 * (enc.cfg.attdim // 2 + rdim)


def test_rpe_vectors_start_at_the_identity():
    """rpe's q/k/v vectors: a flattened 4x4 identity, then (1, 0) per SO(2)
    column, per head (reference layers.py:257-264)."""
    from gta_tpu_torch.config import AttnConfig

    layer = Attention(16, heads=3, dim_head=8, attn=AttnConfig(method="invatt_directsum", rpe=True, rpe_so2=2))
    want = np.concatenate([np.eye(4).ravel(), np.tile([1.0, 0.0], 4)])
    for b in (layer.q_bias, layer.k_bias, layer.v_bias):
        np.testing.assert_array_equal(b.detach().numpy(), np.tile(want, (3, 1)))


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_posenc_2d_matches_jax(rng):
    """The fixed grid encoding exactly (numpy on both sides); the coordinate
    encoding at pixel scale (arguments up to ~320 rad: a few ulps)."""
    np.testing.assert_array_equal(coords.posenc_2d_grid(180, 8, 10), jcoords.posenc_2d_grid(180, 8, 10))
    c = rng.rand(2, 3, 5, 2).astype(np.float32)
    _close(coords.posenc_2d_coord(180, _t(c), (240, 320)),
           jcoords.posenc_2d_coord(180, jnp.asarray(c), (240, 320)), atol=1e-5)


def test_frustum_points_match_jax(rng):
    c = rng.rand(2, 3, 5, 2).astype(np.float32)
    E = np.stack([random_se3(rng, 3) for _ in range(2)])
    np.testing.assert_array_equal(frustum.normalized_intrinsics(), jfrustum.normalized_intrinsics())
    for D, dmax in ((30, 20.0), (4, 10.0)):
        _close(frustum.frustum_pixel_points(_t(c), _t(E), D, dmax=dmax),
               jfrustum.frustum_pixel_points(jnp.asarray(c), jnp.asarray(E), D, dmax=dmax), atol=1e-5)


def test_plucker_matches_jax(rng):
    """Plücker parameters, pairwise distances (skew and parallel lines) and
    the sine / cosine encoding."""
    r1, r2 = rng.randn(2, 7, 6).astype(np.float32), rng.randn(2, 5, 6).astype(np.float32)
    r2[:, 0, 3:] = r1[:, 0, 3:]  # a pair of parallel lines: the other branch
    p1, p2 = plucker.plucker_params(_t(r1)), plucker.plucker_params(_t(r2))
    _close(p1, jplucker.plucker_params(jnp.asarray(r1)))
    _close(plucker.plucker_dist(p1, p2), jplucker.plucker_dist(jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy())),
           atol=1e-5)
    _close(plucker.plucker_posenc(_t(r1)), jplucker.plucker_posenc(jnp.asarray(r1)), atol=1e-5)
    _close(plucker.plucker_posenc(_t(r1), 4, parameterize="plucker"),
           jplucker.plucker_posenc(jnp.asarray(r1), 4, parameterize="plucker"), atol=1e-5)


def test_t2_and_ray_frames_match_jax(rng):
    """T(2) matrices (the translation in the bottom row), their analytic
    inverse, their action on triples, and the per-ray rotation frames
    (ray_to_se3), also for a ray along world z (the fallback axis)."""
    c = rng.rand(2, 5, 2).astype(np.float32)
    m, mi = t2.make_t2_mats(_t(c)), t2.make_t2_mats_inv(_t(c))
    _close(m, jt2.make_t2_mats(jnp.asarray(c)))
    _close(mi, jt2.make_t2_mats_inv(jnp.asarray(c)))
    _close(m @ mi, np.broadcast_to(np.eye(3), m.shape))
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    _close(t2.apply_t2(m, _t(x)), jt2.apply_t2(jt2.make_t2_mats(jnp.asarray(c)), jnp.asarray(x)))
    d = rng.randn(2, 5, 3).astype(np.float32)
    d[0, 0] = [0.0, 0.0, 2.0]
    for four in (False, True):
        _close(rays.ray_to_rotation(_t(d), four), jrays.ray_to_rotation(jnp.asarray(d), four))
