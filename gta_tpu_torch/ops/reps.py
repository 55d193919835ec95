"""Per-batch geometric representation tables (`GeomReps`).

Computed once per batch by pure functions from the scene geometry and
threaded explicitly through the model (the reference threads them through a
mutable `extras` dict, encoder.py:183-265, decoder.py:247-353).

  * SO(2) is stored as (cos, sin) rotor tables and applied RoPE-style.
  * SE(3) inverses are analytic (rotation transpose), never linear solves.

This slice ports the se3 and so2 spans, which the flagship CLEVR-TR GTA
model uses; the other rep types raise NotImplementedError naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.geometry.se3 import se3_inverse
from gta_tpu_torch.geometry.so2 import so2_angles


@dataclasses.dataclass
class GeomReps:
    """Representation tables for one attention call (query side vs key side).

    Shapes (B batch, Nq/Nk views, Tq/Tk tokens per side, R rotors):
      so2_*:     (cos, sin) each [B, T, R]
      se3_*:     [B, N, 4, 4]
      se3_q_inv: the unmasked inverse (i.e. the original extrinsic)
    """

    so2_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    so2_k: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    se3_q: Optional[torch.Tensor] = None
    se3_q_inv: Optional[torch.Tensor] = None
    se3_k: Optional[torch.Tensor] = None


def _check_supported(args: GTAArgs):
    fd = args.f_dims
    if fd.so3 > 0:
        raise NotImplementedError("so3 (Wigner-D) reps are not ported yet (ROADMAP queue 1, msn_so3 slice)")
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
    return r
