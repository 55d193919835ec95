"""Parity of the port's geometry and rep tables (gta_tpu_torch/geometry,
ops/reps.py, ops/gta.py table builders) with the JAX package.

The same numpy inputs go through the JAX function and its port; fp32
results agree to atol 1e-6, numpy builders exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import FDims as JFDims, GTAArgs as JGTAArgs
from gta_tpu.geometry import coords as jcoords, rays as jrays, se3 as jse3, so2 as jso2
from gta_tpu.ops import gta as jgta
from gta_tpu.ops.reps import decoder_reps as j_decoder_reps, encoder_reps as j_encoder_reps
from gta_tpu_torch.config import FDims, GTAArgs
from gta_tpu_torch.geometry import coords, rays, se3, so2
from gta_tpu_torch.ops import gta as tgta
from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps
from tests.conftest import random_se3

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("shared", [False, True])
def test_so2_angles(rng, shared):
    coord = rng.rand(2, 3, 7, 2).astype(np.float32)
    want = jso2.so2_angles(jnp.asarray(coord), 8, (1.0, 0.5), shared)
    _close(so2.so2_angles(_t(coord), 8, (1.0, 0.5), shared), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_rotor(rng, inverse):
    theta = rng.rand(4, 5).astype(np.float32) * 6.0
    x = rng.randn(4, 5, 2).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    jfn = jso2.apply_rotor_inv if inverse else jso2.apply_rotor
    tfn = so2.apply_rotor_inv if inverse else so2.apply_rotor
    _close(tfn(_t(c), _t(s), _t(x)), jfn(jnp.asarray(c), jnp.asarray(s), jnp.asarray(x)))


def test_se3_inverse_and_scale_mask(rng):
    tf = random_se3(rng, 6)
    _close(se3.se3_inverse(_t(tf)), jse3.se3_inverse(jnp.asarray(tf)))
    _close(se3.scale_mask(torch.tensor([0.37])), jse3.scale_mask(jnp.asarray([0.37])))
    _close(se3.scale_mask(1.0), jse3.scale_mask(1.0))


def test_coords_and_posenc(rng):
    np.testing.assert_array_equal(coords.make_2dcoord(5, 7), jcoords.make_2dcoord(5, 7))
    pts = rng.randn(3, 9, 3).astype(np.float32)
    _close(coords.octave_posenc(_t(pts), 6, -5), jcoords.octave_posenc(jnp.asarray(pts), 6, -5))
    dirs = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    pos = pts * 8.0
    _close(
        coords.ray_posenc(_t(pos), _t(dirs), 15, -5, 15),
        jcoords.ray_posenc(jnp.asarray(pos), jnp.asarray(dirs), 15, -5, 15),
    )


def test_rays_and_extrinsics(rng):
    cam = np.array([6.0, -4.0, 3.5], np.float32)
    np.testing.assert_array_equal(rays.lookat_extrinsic(cam), jrays.lookat_extrinsic(cam))
    ext = rays.lookat_extrinsic(cam)
    np.testing.assert_array_equal(
        rays.camera_rays_from_extrinsic(ext, cam, 12, 8),
        jrays.camera_rays_from_extrinsic(ext, cam, 12, 8),
    )
    pts = rng.randn(2, 5, 3).astype(np.float32)
    tf = random_se3(rng, 2)[:, None]
    for translate in (True, False):
        np.testing.assert_array_equal(
            rays.transform_points(pts, tf, translate), jrays.transform_points(pts, tf, translate)
        )


MIXES = [(dict(se3=32, so2=32), 8), (dict(triv=4, se3=8, so2=8), 2), (dict(so2=16), 4)]


def _geometry(rng, b=2, nv=2, tpv=6, nt=3, tt=5):
    return (
        rng.rand(b, nv, tpv, 2).astype(np.float32),
        np.stack([random_se3(rng, nv) for _ in range(b)]),
        rng.rand(b, nt, tt, 2).astype(np.float32),
        np.stack([random_se3(rng, nt) for _ in range(b)]),
    )


def _close_reps(treps, jreps):
    for name in ("so2_q", "so2_k"):
        t, j = getattr(treps, name), getattr(jreps, name)
        assert (t is None) == (j is None), name
        if t is not None:
            _close(t[0], j[0])
            _close(t[1], j[1])
    for name in ("se3_q", "se3_q_inv", "se3_k"):
        t, j = getattr(treps, name), getattr(jreps, name)
        assert (t is None) == (j is None), name
        if t is not None:
            _close(t, j)


@pytest.mark.parametrize("fd,nf", MIXES)
def test_encoder_and_decoder_reps(rng, fd, nf):
    jargs = JGTAArgs(f_dims=JFDims(**fd), so2=nf)
    targs = GTAArgs(f_dims=FDims(**fd), so2=nf)
    ic, itf, tc, ttf = _geometry(rng)
    jenc = j_encoder_reps(jargs, jnp.asarray(ic), jnp.asarray(itf), None)
    tenc = encoder_reps(targs, _t(ic), _t(itf))
    _close_reps(tenc, jenc)
    for reuse in (True, False):
        jdec = j_decoder_reps(
            jargs, target_coord=jnp.asarray(tc), target_transforms=jnp.asarray(ttf),
            input_coord=jnp.asarray(ic), input_transforms=jnp.asarray(itf),
            enc=jenc if reuse else None,
        )
        tdec = decoder_reps(
            targs, target_coord=_t(tc), target_transforms=_t(ttf),
            input_coord=_t(ic), input_transforms=_t(itf), enc=tenc if reuse else None,
        )
        _close_reps(tdec, jdec)
        if reuse:
            # key-side tables are the encoder's own, not a recompute
            assert tdec.so2_k is tenc.so2_k and tdec.se3_k is tenc.se3_k


@pytest.mark.parametrize("fd,nf", MIXES)
def test_blockdiag_tables(rng, fd, nf):
    jargs = JGTAArgs(f_dims=JFDims(**fd), so2=nf)
    targs = GTAArgs(f_dims=FDims(**fd), so2=nf)
    ic, itf, tc, ttf = _geometry(rng)
    jdec = j_decoder_reps(
        jargs, target_coord=jnp.asarray(tc), target_transforms=jnp.asarray(ttf),
        input_coord=jnp.asarray(ic), input_transforms=jnp.asarray(itf),
    )
    tdec = decoder_reps(
        targs, target_coord=_t(tc), target_transforms=_t(ttf),
        input_coord=_t(ic), input_transforms=_t(itf),
    )
    assert tgta._blockdiag_ok(tdec, targs) == jgta._blockdiag_ok(jdec, jargs)
    assert tgta._view_counts(tdec) == jgta._view_counts(jdec)
    for side in ("q", "k", "out"):
        want = jgta._blockdiag_mat(jdec, jargs, jnp.asarray([0.23]), side, jnp.float32)
        got = tgta._blockdiag_mat(tdec, targs, torch.tensor([0.23]), side, torch.float32)
        assert (got is None) == (want is None)
        if got is not None:
            _close(got, want)
    if tdec.so2_q is not None:
        want = jgta._fw_rotors(jdec.so2_q, jargs.f_dims, jnp.float32)
        got = tgta._fw_rotors(tdec.so2_q, targs.f_dims, torch.float32)
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("kw", [
    dict(f_dims=FDims(se3=16, so3=16, t2=6), so3=2),
    dict(f_dims=FDims(triv=2, se3=16, t2=6)),
    dict(f_dims=FDims(se3=16, so2=8), so2=2, ray_to_se3=True),
    dict(f_dims=FDims(se3=16, so2=8), so2=2, elementwise_mul=True),
])
def test_unported_reps_raise(rng, kw):
    """The rep mixes that raised before the other attention methods were
    ported (t2, per-token SE(3) from ray_to_se3, elementwise_mul's
    flattened reps) now build, and every table of the encoder's and the
    decoder's GeomReps matches the JAX package's."""
    import dataclasses

    from gta_tpu.config import GTAArgs as JArgs

    jkw = dict(kw, f_dims=JFDims(**dataclasses.asdict(kw["f_dims"])))
    ic, itf, tc, ttf = _geometry(rng)
    irays = rng.randn(*ic.shape[:3], 3).astype(np.float32)
    trays = rng.randn(*tc.shape[:3], 3).astype(np.float32)
    jenc = j_encoder_reps(JArgs(**jkw), jnp.asarray(ic), jnp.asarray(itf), jnp.asarray(irays))
    tenc = encoder_reps(GTAArgs(**kw), _t(ic), _t(itf), _t(irays))
    jdec = j_decoder_reps(JArgs(**jkw), jnp.asarray(tc), jnp.asarray(ttf), jnp.asarray(trays), jnp.asarray(ic),
                          jnp.asarray(itf), jnp.asarray(irays), jenc)
    tdec = decoder_reps(GTAArgs(**kw), _t(tc), _t(ttf), _t(trays), _t(ic), _t(itf), _t(irays), tenc)
    for treps, jreps in ((tenc, jenc), (tdec, jdec)):
        for f in dataclasses.fields(treps):
            t, j = getattr(treps, f.name), getattr(jreps, f.name)
            assert (t is None) == (j is None), f.name
            for a, b in zip(*((t, j) if isinstance(t, tuple) else ((t,), (j,)))) if t is not None else ():
                _close(a, b)


def test_downsample_grid(rng):
    from gta_tpu.models.encoder import downsample_grid as j_downsample_grid
    from gta_tpu_torch.models.encoder import downsample_grid

    grid = rng.rand(2, 3, 32, 48, 3).astype(np.float32)
    for steps in (0, 1, 3):
        np.testing.assert_array_equal(
            downsample_grid(_t(grid), steps).numpy(), np.asarray(j_downsample_grid(jnp.asarray(grid), steps))
        )
