"""The port's Wigner-D matrices (gta_tpu_torch/geometry/wigner.py) against
the JAX package's (gta_tpu/geometry/wigner.py), on the CPU.

The same float32 rotations go through both: random rotations, R = I (every
canonical input view 0 has the identity camera), Ry(pi), and rotations just
inside and just outside each gimbal-lock mask (|R22 -/+ 1| < EPS), for
degrees 1-4 at atol 1e-6 (fp32; the einsum order of the small-d sum
differs). The group properties tests/test_wigner.py checks hold for the
port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.geometry import wigner as jw
from gta_tpu_torch.geometry import wigner as tw
from tests.conftest import random_rotation

MAX_DEGREE = 4
ATOL = 1e-6
PROP_ATOL = 1e-4  # tests/test_wigner.py's tolerance for the group properties


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    m = np.zeros((len(a), 3, 3))
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1], m[:, 2, 2] = c, -s, s, c, 1
    return m


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    m = np.zeros((len(a), 3, 3))
    m[:, 0, 0], m[:, 0, 2], m[:, 2, 0], m[:, 2, 2], m[:, 1, 1] = c, s, -s, c, 1
    return m


def _zyz(g1, g2, g3):
    """R = Rz(g3) Ry(g2) Rz(g1), float32."""
    return (_rz(np.asarray(g3)) @ _ry(np.asarray(g2)) @ _rz(np.asarray(g1))).astype(np.float32)


def _ds(R, max_degree=MAX_DEGREE):
    return [D.numpy() for D in tw.wigner_d_matrices(max_degree, torch.from_numpy(np.asarray(R, np.float32)))]


def _both(R):
    R = np.asarray(R, np.float32)
    want = [np.asarray(D) for D in jw.wigner_d_matrices(MAX_DEGREE, jnp.asarray(R))]
    return _ds(R), want


def _mask_edges():
    """Rotations whose R22 lies 0.3 EPS and 3 EPS from +1 and from -1: each
    gimbal mask's inside and outside (float32 R22 still resolves both)."""
    rng = np.random.RandomState(1)
    n = 4
    g1, g3 = rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n)
    out = []
    for frac in (0.3, 3.0):
        beta = np.arccos(1.0 - frac * tw.EPS) * np.ones(n)
        out += [_zyz(g1, beta, g3), _zyz(g1, np.pi - beta, g3)]
    return np.concatenate(out)


CASES = {
    "random": lambda: random_rotation(np.random.RandomState(0), 64),
    "identity": lambda: np.tile(np.eye(3), (2, 1, 1)),
    "ry_pi": lambda: _ry(np.full(2, np.pi)),
    "flip_z": lambda: _rz(np.array([0.4, 1.1])) @ np.diag([1.0, -1.0, -1.0])[None],
    "mask_edges": _mask_edges,
}


@pytest.mark.parametrize("case", list(CASES))
def test_wigner_d_matches_jax(case):
    got, want = _both(CASES[case]())
    assert len(got) == len(want) == MAX_DEGREE + 1
    for l in range(1, MAX_DEGREE + 1):
        assert got[l].shape == want[l].shape == (len(CASES[case]()), 2 * l + 1, 2 * l + 1)
        np.testing.assert_allclose(got[l], want[l], atol=ATOL, err_msg=f"{case} degree {l}")


def test_euler_angles_and_gimbal_masks_match_jax():
    """The masks fire on the same rotations in both frameworks, and replace
    the generic angles the same way: at R = I the generic g1 is
    atan2(0, -0.0) = pi in both, and the top mask sets it to 0."""
    assert torch.atan2(torch.tensor(0.0), torch.tensor(-0.0)).item() == pytest.approx(np.pi)
    assert float(jnp.arctan2(0.0, -0.0)) == pytest.approx(np.pi)
    R = np.concatenate([np.tile(np.eye(3), (1, 1, 1)), _mask_edges(), _ry(np.full(1, np.pi))]).astype(np.float32)
    got = tw.rotmat_to_zyz_euler(torch.from_numpy(R))
    want = jw.rotmat_to_zyz_euler(jnp.asarray(R))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert [float(g[0]) for g in got] == [0.0, 0.0, 0.0]  # R = I
    assert float(got[2][-1]) == 0.0 and float(got[1][-1]) == pytest.approx(np.pi)  # Ry(pi): bottom


def test_degree_tables_match_jax():
    for l in range(MAX_DEGREE + 1):
        for a, b in zip(tw._degree_tables(l), jw._degree_tables(l)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_identity_orthogonality_inverse():
    for l, D in enumerate(_ds(np.tile(np.eye(3), (4, 1, 1)))):
        np.testing.assert_allclose(D, np.tile(np.eye(2 * l + 1), (4, 1, 1)), atol=PROP_ATOL)
    R = random_rotation(np.random.RandomState(2), 16)
    Ds, Dinv = _ds(R), _ds(np.swapaxes(R, -1, -2))
    for l in range(MAX_DEGREE + 1):
        D = Ds[l].astype(np.float64)
        np.testing.assert_allclose(D @ np.swapaxes(D, -1, -2), np.tile(np.eye(2 * l + 1), (16, 1, 1)), atol=PROP_ATOL)
        np.testing.assert_allclose(Dinv[l], np.swapaxes(Ds[l], -1, -2), atol=PROP_ATOL)


def test_homomorphism():
    rng = np.random.RandomState(3)
    R1, R2 = random_rotation(rng, 16), random_rotation(rng, 16)
    D1, D2, D12 = _ds(R1), _ds(R2), _ds(R1 @ R2)
    for l in range(MAX_DEGREE + 1):
        np.testing.assert_allclose(D12[l], D1[l].astype(np.float64) @ D2[l], atol=PROP_ATOL)


def test_degree1_conjugate_to_rotation():
    """D^1(R) = P R P^T with P the signed permutation (x,y,z)->(y,-z,-x),
    as for the JAX package (the real-harmonics basis convention)."""
    R = random_rotation(np.random.RandomState(4), 16)
    P = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]])
    np.testing.assert_allclose(_ds(R, 1)[1], P @ R @ P.T, atol=PROP_ATOL)
