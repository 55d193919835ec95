"""Per-batch geometric representation tables (`GeomReps`).

Computed once per batch by pure functions from the scene geometry and
threaded explicitly through the model (the reference threads them through a
mutable `extras` dict, encoder.py:183-265, decoder.py:247-353).

  * SO(2) is stored as (cos, sin) rotor tables and applied RoPE-style.
  * SE(3) inverses are analytic (rotation transpose), never linear solves.
  * SO(3) Wigner-D matrices are built in-process (geometry/wigner.py).

The se3, so3 and so2 spans are ported; t2, ray_to_se3 and elementwise_mul
raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.geometry.se3 import se3_inverse
from gta_tpu_torch.geometry.so2 import so2_angles
from gta_tpu_torch.geometry.wigner import wigner_d_matrices


@dataclasses.dataclass
class GeomReps:
    """Representation tables for one attention call (query side vs key side).

    Shapes (B batch, Nq/Nk views, Tq/Tk tokens per side, R rotors):
      so2_*:     (cos, sin) each [B, T, R]
      se3_*:     [B, N, 4, 4]
      se3_q_inv: the unmasked inverse (i.e. the original extrinsic)
      so3_*:     tuple over degrees 1..n of [B, N, 2d+1, 2d+1]
    """

    so2_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    so2_k: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    se3_q: Optional[torch.Tensor] = None
    se3_q_inv: Optional[torch.Tensor] = None
    se3_k: Optional[torch.Tensor] = None
    so3_q: Optional[Tuple[torch.Tensor, ...]] = None
    so3_k: Optional[Tuple[torch.Tensor, ...]] = None


def _check_supported(args: GTAArgs):
    fd = args.f_dims
    if fd.t2 > 0:
        raise NotImplementedError("t2 reps are not ported yet (ROADMAP queue 1, other attention methods)")
    if args.ray_to_se3:
        raise NotImplementedError("ray_to_se3 is not ported yet (ROADMAP queue 1, other attention methods)")
    if args.elementwise_mul:
        raise NotImplementedError(
            "elementwise_mul is not ported yet (ROADMAP queue 1, other attention methods)"
        )


def _so2_rotors(coord: torch.Tensor, args: GTAArgs):
    """coord [B, N, T, 2] (or [B, T, 2]) -> (cos, sin) each [B, N*T, R]."""
    coord = coord.reshape(coord.shape[0], -1, 2)
    theta = so2_angles(coord, args.so2, (args.max_freq_h, args.max_freq_w), args.shared_freqs)
    return torch.cos(theta), torch.sin(theta)


def _so3_reps(transforms: torch.Tensor, args: GTAArgs) -> Tuple[torch.Tensor, ...]:
    """Wigner-D matrices of degrees 1..so3 from the rotations of inv(E):
    a tuple of [B, N, 2d+1, 2d+1], zeros under `zeroout_so3`, identities
    under `id_so3` (reference encoder.py:251-258)."""
    R = se3_inverse(transforms)[..., :3, :3]
    B, N = R.shape[0], R.shape[1]
    out = []
    for D in wigner_d_matrices(args.so3, R.reshape(B * N, 3, 3))[1:]:
        d = D.shape[-1]
        if args.zeroout_so3:
            D = torch.zeros((B, N, d, d), dtype=D.dtype, device=D.device)
        elif args.id_so3:
            D = torch.eye(d, dtype=D.dtype, device=D.device).expand(B, N, d, d)
        out.append(D.reshape(B, N, d, d))
    return tuple(out)


def encoder_reps(
    args: GTAArgs,
    input_coord: Optional[torch.Tensor] = None,
    input_transforms: Optional[torch.Tensor] = None,
    input_rays: Optional[torch.Tensor] = None,
) -> GeomReps:
    """Self-attention reps: query side == key side == input views.

    input_coord: [B, N, T', 2] patch-center coords; input_transforms:
    [B, N, 4, 4] relative extrinsics (canonical frame).
    """
    _check_supported(args)
    fd = args.f_dims
    r = GeomReps()
    if fd.so2 > 0:
        rot = _so2_rotors(input_coord, args)
        r.so2_q = r.so2_k = rot
    if fd.se3 > 0:
        rho = se3_inverse(input_transforms)
        r.se3_q, r.se3_q_inv, r.se3_k = rho, input_transforms, rho
    if fd.so3 > 0:
        r.so3_q = r.so3_k = _so3_reps(input_transforms, args)
    return r


def decoder_reps(
    args: GTAArgs,
    target_coord: Optional[torch.Tensor] = None,
    target_transforms: Optional[torch.Tensor] = None,
    target_rays: Optional[torch.Tensor] = None,
    input_coord: Optional[torch.Tensor] = None,
    input_transforms: Optional[torch.Tensor] = None,
    input_rays: Optional[torch.Tensor] = None,
    enc: Optional[GeomReps] = None,
) -> GeomReps:
    """Cross-attention reps: query side = target rays, key side = input views.

    Key-side tables are reused from the encoder's GeomReps when available
    (reference decoder.py:311 `'se3rep_k' not in extras`); otherwise they
    are recomputed from the input geometry.
    """
    _check_supported(args)
    fd = args.f_dims
    r = GeomReps()
    if fd.so2 > 0:
        rot_q = _so2_rotors(target_coord, args)
        if args.recompute_so2 or enc is None or enc.so2_k is None:
            rot_k = _so2_rotors(input_coord, args)
        else:
            rot_k = enc.so2_k
        r.so2_q, r.so2_k = rot_q, rot_k
    if fd.se3 > 0:
        r.se3_q = se3_inverse(target_transforms)
        r.se3_q_inv = target_transforms
        if enc is not None and enc.se3_k is not None:
            r.se3_k = enc.se3_k
        else:
            r.se3_k = se3_inverse(input_transforms)
    if fd.so3 > 0:
        r.so3_q = _so3_reps(target_transforms, args)
        if enc is not None and enc.so3_k is not None:
            r.so3_k = enc.so3_k
        else:
            r.so3_k = _so3_reps(input_transforms, args)
    return r
