"""Per-batch geometric representation tables (`GeomReps`).

Computed once per batch by pure functions from the scene geometry and
threaded explicitly through the model (the reference threads them through a
mutable `extras` dict, encoder.py:183-265, decoder.py:247-353).

  * SO(2) is stored as (cos, sin) rotor tables and applied RoPE-style.
  * SE(3) and T(2) inverses are analytic (rotation transpose, negated
    translation), never linear solves.
  * SO(3) Wigner-D matrices are built in-process (geometry/wigner.py).
  * `ray_to_se3` refines the SE(3) tables per token by each ray's frame
    ([B, N, T', 4, 4]); `elementwise_mul` adds the flattened reps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.geometry.rays import ray_to_rotation
from gta_tpu_torch.geometry.se3 import se3_inverse
from gta_tpu_torch.geometry.so2 import make_so2_mats, so2_angles
from gta_tpu_torch.geometry.t2 import make_t2_mats, make_t2_mats_inv
from gta_tpu_torch.geometry.wigner import wigner_d_matrices


@dataclasses.dataclass
class GeomReps:
    """Representation tables for one attention call (query side vs key side).

    Shapes (B batch, Nq/Nk views, Tq/Tk tokens per side, R rotors):
      so2_*:     (cos, sin) each [B, T, R]
      se3_*:     [B, N, 4, 4] (or [B, N, T', 4, 4] with ray_to_se3)
      se3_q_inv: the unmasked inverse (i.e. the original extrinsic)
      so3_*:     tuple over degrees 1..n of [B, N, 2d+1, 2d+1]
      t2_*:      [B, T, 3, 3]
      flat_*:    [B, T, F] flattened rep vectors (elementwise_mul)
    """

    so2_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    so2_k: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    se3_q: Optional[torch.Tensor] = None
    se3_q_inv: Optional[torch.Tensor] = None
    se3_k: Optional[torch.Tensor] = None
    so3_q: Optional[Tuple[torch.Tensor, ...]] = None
    so3_k: Optional[Tuple[torch.Tensor, ...]] = None
    t2_q: Optional[torch.Tensor] = None
    t2_q_inv: Optional[torch.Tensor] = None
    t2_k: Optional[torch.Tensor] = None
    flat_q: Optional[torch.Tensor] = None
    flat_k: Optional[torch.Tensor] = None
    flat_q_inv: Optional[torch.Tensor] = None


def _so2_rotors(coord: torch.Tensor, args: GTAArgs):
    """coord [B, N, T, 2] (or [B, T, 2]) -> (cos, sin) each [B, N*T, R]."""
    coord = coord.reshape(coord.shape[0], -1, 2)
    theta = so2_angles(coord, args.so2, (args.max_freq_h, args.max_freq_w), args.shared_freqs)
    return torch.cos(theta), torch.sin(theta)


def _so2_flat(coord: torch.Tensor, args: GTAArgs):
    """Flattened SO(2) rep and its inverse, each [B, T, R*4] (elementwise_mul)."""
    coord = coord.reshape(coord.shape[0], -1, 2)
    mats = make_so2_mats(coord, args.so2, (args.max_freq_h, args.max_freq_w), args.shared_freqs)
    B, T = mats.shape[0], mats.shape[1]
    return mats.reshape(B, T, -1), mats.transpose(-1, -2).reshape(B, T, -1)


def _se3_reps(transforms: torch.Tensor, args: GTAArgs, rays: Optional[torch.Tensor]):
    """rho = inv(E) and its inverse E; with ray_to_se3, refined per token by
    the ray frames R (rays [B, N, T', 3]): rho R and R^T E (reference
    encoder.py:220-231)."""
    rho, inv = se3_inverse(transforms), transforms
    if args.ray_to_se3:
        if rays is None:
            raise ValueError("ray_to_se3 requires rays")
        R = ray_to_rotation(rays, return_4x4=True)  # [B, N, T, 4, 4]
        rho = torch.einsum("bnij,bntjk->bntik", rho, R)
        inv = torch.einsum("bntij,bnjk->bntik", R.transpose(-1, -2), inv)
    return rho, inv


def _se3_flat(extrinsic: torch.Tensor, tokens_per_side: int):
    """Flattened SE(3) rep vectors [B, T, 16] and inverses (elementwise_mul,
    reference encoder.py:238-243): the extrinsic transposed is the rep, the
    extrinsic itself the inverse, repeated per token."""
    B, N = extrinsic.shape[0], extrinsic.shape[1]
    reps = extrinsic.repeat_interleave(tokens_per_side // N, dim=1)  # [B, T, 4, 4]
    return reps.transpose(-1, -2).reshape(B, -1, 16), reps.reshape(B, -1, 16)


def _flat(coord, transforms, args: GTAArgs, n_tokens):
    """(flat, flat_inv) of a side: SO(2) then SE(3) parts, concatenated."""
    fd = args.f_dims
    flats, flats_inv = [], []
    if fd.so2 > 0:
        f, fi = _so2_flat(coord, args)
        flats.append(f)
        flats_inv.append(fi)
    if fd.se3 > 0:
        if n_tokens is None:
            raise ValueError("elementwise_mul SE(3) needs a token count (SO(2) or T(2) active)")
        f, fi = _se3_flat(transforms, n_tokens)
        flats.append(f)
        flats_inv.append(fi)
    return torch.cat(flats, -1), torch.cat(flats_inv, -1)


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
    [B, N, 4, 4] relative extrinsics (canonical frame); input_rays:
    [B, N, T', 3] patch-center rays (ray_to_se3 only).
    """
    fd = args.f_dims
    r = GeomReps()
    n_tokens = None
    if fd.so2 > 0:
        rot = _so2_rotors(input_coord, args)
        n_tokens = rot[0].shape[1]
        r.so2_q = r.so2_k = rot
    if fd.t2 > 0:
        coord = input_coord.reshape(input_coord.shape[0], -1, 2)
        n_tokens = coord.shape[1]
        r.t2_q, r.t2_q_inv, r.t2_k = make_t2_mats(coord), make_t2_mats_inv(coord), make_t2_mats(coord)
    if fd.se3 > 0:
        rho, inv = _se3_reps(input_transforms, args, input_rays)
        r.se3_q, r.se3_q_inv, r.se3_k = rho, inv, rho
    if fd.so3 > 0:
        r.so3_q = r.so3_k = _so3_reps(input_transforms, args)
    if args.elementwise_mul:
        flat, flat_inv = _flat(input_coord, input_transforms, args, n_tokens)
        r.flat_q, r.flat_k, r.flat_q_inv = flat, flat, flat_inv
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
    fd = args.f_dims
    r = GeomReps()
    n_tokens = None
    if fd.so2 > 0:
        r.so2_q = _so2_rotors(target_coord, args)
        n_tokens = r.so2_q[0].shape[1]
        if args.recompute_so2 or enc is None or enc.so2_k is None:
            r.so2_k = _so2_rotors(input_coord, args)
        else:
            r.so2_k = enc.so2_k
    if fd.t2 > 0:
        coord = target_coord.reshape(target_coord.shape[0], -1, 2)
        n_tokens = coord.shape[1]
        r.t2_q, r.t2_q_inv = make_t2_mats(coord), make_t2_mats_inv(coord)
        if enc is not None and enc.t2_k is not None:
            r.t2_k = enc.t2_k
        else:
            r.t2_k = make_t2_mats(input_coord.reshape(input_coord.shape[0], -1, 2))
    if fd.se3 > 0:
        r.se3_q, r.se3_q_inv = _se3_reps(target_transforms, args, target_rays)
        if enc is not None and enc.se3_k is not None:
            r.se3_k = enc.se3_k
        else:
            r.se3_k = _se3_reps(input_transforms, args, input_rays)[0]
    if fd.so3 > 0:
        r.so3_q = _so3_reps(target_transforms, args)
        if enc is not None and enc.so3_k is not None:
            r.so3_k = enc.so3_k
        else:
            r.so3_k = _so3_reps(input_transforms, args)
    if args.elementwise_mul:
        r.flat_q, r.flat_q_inv = _flat(target_coord, target_transforms, args, n_tokens)
        r.flat_k = enc.flat_k if enc is not None else None
    return r
