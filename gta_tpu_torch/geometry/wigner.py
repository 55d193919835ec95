"""Real Wigner-D matrices (orthogonal SO(3) irreps), built in-process.

The port's own copy of gta_tpu/geometry/wigner.py: the same numpy tables
(no precomputed `J_dense.pt`), the same ZYZ convention and the same
gimbal-lock masks, with the runtime math in torch.

  1. Wigner small-d matrices d^l(beta) by the closed-form factorial sum, as
     a coefficient tensor over monomials cos(beta/2)^p sin(beta/2)^(2l-p).
  2. The change to *real* spherical harmonics, B(beta) = U d(beta) U^H,
     contracted into the coefficient tensor once in numpy (complex128), so
     the runtime math is real.
  3. D_real(R) = Z(g3) @ B(g2) @ Z(g1) for the ZYZ Euler angles of
     R = Rz(g3) Ry(g2) Rz(g1), with Z(a) the real z-rotation rep built from
     one-hot tables.

GTA attention consumes D detached (reference gta.py:194-197), so no gradient
flows through the Euler angles.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

EPS = 1e-5


def _small_d_coeffs(l: int) -> np.ndarray:
    """Coefficient tensor W[a, b, p] (complex basis, m = -l..l ordering):

    d^l_{m'm}(beta) = sum_p W[l+m', l+m, p] cos(beta/2)^p sin(beta/2)^(2l-p)
    """
    n = 2 * l + 1
    W = np.zeros((n, n, n), dtype=np.float64)
    f = math.factorial
    for mp in range(-l, l + 1):  # m'
        for m in range(-l, l + 1):
            pref = math.sqrt(f(l + mp) * f(l - mp) * f(l + m) * f(l - m))
            for s in range(max(0, m - mp), min(l + m, l - mp) + 1):
                p = 2 * l + m - mp - 2 * s  # cos power; the sin power is 2l - p
                c = ((-1.0) ** (mp - m + s)) * pref / (
                    f(l + m - s) * f(s) * f(mp - m + s) * f(l - mp - s)
                )
                W[l + mp, l + m, p] += c
    return W


def _real_basis_U(l: int) -> np.ndarray:
    """Unitary complex->real SH change of basis, rows = real mu, cols = complex m."""
    n = 2 * l + 1
    U = np.zeros((n, n), dtype=np.complex128)
    U[l, l] = 1.0
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for m in range(1, l + 1):
        U[l + m, l + m] = ((-1.0) ** m) * inv_sqrt2
        U[l + m, l - m] = inv_sqrt2
        U[l - m, l + m] = -1j * ((-1.0) ** m) * inv_sqrt2
        U[l - m, l - m] = 1j * inv_sqrt2
    return U


@lru_cache(maxsize=None)
def _degree_tables(l: int):
    """Static real tables of degree l, as numpy float32 arrays:
    (Wr [n,n,n], Ediag [n,n,n], Eanti [n,n,n], ms [n], zsign) with

      B(beta)  = einsum('abp,...p->...ab', Wr, basis(beta))
      Z(alpha) = einsum('...a,aij->...ij', cos(m*alpha), Ediag)
               + zsign * einsum('...a,aij->...ij', sin(m*alpha), Eanti)
    """
    n = 2 * l + 1
    W = _small_d_coeffs(l)
    U = _real_basis_U(l)
    Wc = np.einsum("ac,cdp,bd->abp", U, W.astype(np.complex128), U.conj())
    im = np.abs(Wc.imag).max()
    assert im < 1e-10, f"real-basis Wigner-d not real at degree {l}: imag={im}"
    Wr = Wc.real

    ms = np.arange(-l, l + 1, dtype=np.float64)  # frequency per basis index
    Ediag = np.zeros((n, n, n))
    Eanti = np.zeros((n, n, n))
    for a in range(n):
        Ediag[a, a, a] = 1.0
        Eanti[a, a, n - 1 - a] = 1.0

    # the anti-diagonal's sign, from U diag(e^{-i m alpha}) U^H
    alpha = 0.7
    Zr = U @ np.diag(np.exp(-1j * ms * alpha)) @ U.conj().T
    assert np.abs(Zr.imag).max() < 1e-10
    Zr = Zr.real
    cand = np.einsum("a,aij->ij", np.cos(ms * alpha), Ediag)
    anti = np.einsum("a,aij->ij", np.sin(ms * alpha), Eanti)
    if np.allclose(Zr, cand + anti, atol=1e-9):
        zsign = 1.0
    elif np.allclose(Zr, cand - anti, atol=1e-9):
        zsign = -1.0
    else:
        raise AssertionError(f"z-rotation structure mismatch at degree {l}")
    f32 = np.float32
    return Wr.astype(f32), Ediag.astype(f32), Eanti.astype(f32), ms.astype(f32), zsign


def _table(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype=like.dtype, device=like.device)


def z_rot_mat(angle: torch.Tensor, l: int) -> torch.Tensor:
    """Real z-rotation representation matrix, [..., 2l+1, 2l+1]."""
    _, Ediag, Eanti, ms, zsign = _degree_tables(l)
    th = angle[..., None] * _table(ms, angle)  # [..., n]
    return torch.einsum("...a,aij->...ij", torch.cos(th), _table(Ediag, angle)) + zsign * torch.einsum(
        "...a,aij->...ij", torch.sin(th), _table(Eanti, angle)
    )


def _y_rot_real(beta: torch.Tensor, l: int) -> torch.Tensor:
    """Real rep of Ry(beta): B(beta) = U d^l(beta) U^H, [..., 2l+1, 2l+1]."""
    ch = torch.cos(beta / 2.0)
    sh = torch.sin(beta / 2.0)
    basis = torch.stack([(ch**p) * (sh ** (2 * l - p)) for p in range(2 * l + 1)], -1)
    return torch.einsum("abp,...p->...ab", _table(_degree_tables(l)[0], beta), basis)


def wigner_d_matrix(l: int, g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor) -> torch.Tensor:
    """D^l for ZYZ Euler angles with R = Rz(g3) Ry(g2) Rz(g1): Z(g3) B(g2) Z(g1)."""
    if l == 0:
        return torch.ones((*g1.shape, 1, 1), dtype=g1.dtype, device=g1.device)
    return z_rot_mat(g3, l) @ _y_rot_real(g2, l) @ z_rot_mat(g1, l)


def rotmat_to_zyz_euler(R: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g1, g2, g3) with R = Rz(g3) Ry(g2) Rz(g1), gimbal-lock safe.

    Within EPS of g2 = 0 (`top`: every canonical input view 0, whose camera
    is the identity) or g2 = pi (`bottom`) the generic g1 and g3 are
    replaced: g3 = 0 and g1 from the remaining in-plane rotation. The
    bottom branch is the one consistent with the ZYZ convention,
    atan2(R10, -R00) (the reference's atan2(-R10, -R00) flips its sign).
    """
    g2 = torch.atan2(torch.sqrt(R[..., 0, 2] ** 2 + R[..., 1, 2] ** 2), R[..., 2, 2])
    g1 = torch.atan2(R[..., 2, 1], -R[..., 2, 0])
    g3 = torch.atan2(R[..., 1, 2], R[..., 0, 2])
    top = torch.abs(R[..., 2, 2] - 1.0) < EPS  # g2 ~ 0
    bottom = torch.abs(R[..., 2, 2] + 1.0) < EPS  # g2 ~ pi
    g1 = torch.where(top, torch.atan2(R[..., 1, 0], R[..., 0, 0]), g1)
    g1 = torch.where(bottom, torch.atan2(R[..., 1, 0], -R[..., 0, 0]), g1)
    g3 = torch.where(top | bottom, torch.zeros_like(g3), g3)
    return g1, g2, g3


def wigner_d_matrices(max_degree: int, R: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """D^l(R) for l = 0..max_degree, each [..., 2l+1, 2l+1] (callers drop
    degree 0)."""
    g1, g2, g3 = rotmat_to_zyz_euler(R)
    return tuple(wigner_d_matrix(l, g1, g2, g3) for l in range(max_degree + 1))
