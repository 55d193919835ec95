"""Geometric transform attention (GTA) — plain PyTorch reference form.

Semantics match reference gta.py:92-279: each head's channel dim is split
into group-typed slices; Q is left-multiplied by the inverse-transpose rep,
K and V by the forward rep; softmax attention runs on the transformed
triple; the inverse query rep is applied to the output.

This is the block-diagonal form: all per-VIEW group factors (SE(3) vec4
blocks, SO(3) Wigner-D blocks, identity on triv and so2 spans) compose into
one [C, C] matrix per view, and the per-TOKEN SO(2) rotors ride one
full-width RoPE pass with identity (cos=1, sin=0) padding outside the so2
span. It is the oracle the
fused kernel (ops/gta_fused.py) is checked against. Rep mixes the
block-diagonal form cannot express (t2, euclid, per-token SE(3)) take the
sliced form, which is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.geometry.se3 import scale_mask
from gta_tpu_torch.geometry.so2 import apply_rotor, apply_rotor_inv
from gta_tpu_torch.ops.reps import GeomReps

AttnFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _fw_rotors(rotors, fd, dtype):
    """Identity-pad (cos, sin) [B, T, R_so2] to full width [B, T, C//2]."""
    cos, sin = rotors
    B, T = cos.shape[0], cos.shape[1]
    cps, sps = [], []
    for name, st, ed in fd.slices():
        r = (ed - st) // 2
        if name == "so2":
            cps.append(cos.to(dtype))
            sps.append(sin.to(dtype))
        else:
            cps.append(torch.ones((B, T, r), dtype=dtype, device=cos.device))
            sps.append(torch.zeros((B, T, r), dtype=dtype, device=cos.device))
    return torch.cat(cps, -1), torch.cat(sps, -1)


def _blockdiag_ok(reps: GeomReps, args: GTAArgs) -> bool:
    if args.euclid_sim:
        return False
    if any(name == "t2" for name, _, _ in args.f_dims.slices()):
        return False
    if reps.se3_q is not None and (reps.se3_q.ndim != 4 or reps.se3_k.ndim != 4):
        return False
    if any(name == "so2" for name, _, _ in args.f_dims.slices()):
        # full-width rotor pairing needs every span 2-aligned
        if any((ed - st) % 2 for _, st, ed in args.f_dims.slices()):
            return False
    return True


def _block_repeat(A: torch.Tensor, g: int) -> torch.Tensor:
    """[B, N, d, d] -> block-diag repeat [B, N, g*d, g*d]."""
    B, N, d, _ = A.shape
    eye = torch.eye(g, dtype=A.dtype, device=A.device)
    return torch.einsum("gh,bnij->bngihj", eye, A).reshape(B, N, g * d, g * d)


def _blockdiag_mat(
    reps: GeomReps,
    args: GTAArgs,
    trans_coeff: Optional[torch.Tensor],
    side: str,
    dtype,
) -> Optional[torch.Tensor]:
    """Compose the per-view [B, N, C, C] block-diagonal rep for one side:
    SE(3) vec4 blocks and SO(3) Wigner-D blocks repeated over their spans.

    side: 'q' (inverse-transpose), 'k' (forward), 'out' (inverse).
    Identity on triv and so2 spans (so2 is per-token, applied separately).
    Returns None when every span is identity (pure-so2/triv configs).
    """
    fd = args.f_dims
    C = fd.total
    parts = []
    for name, st, ed in fd.slices():
        if name == "se3":
            ref = reps.se3_k
            msk = scale_mask(trans_coeff if trans_coeff is not None else 1.0, dtype, ref.device)
            if side == "q":
                A = (reps.se3_q_inv * msk).transpose(-1, -2)
            elif side == "k":
                A = reps.se3_k * msk
            else:
                A = reps.se3_q_inv * msk
            parts.append((st, ed, _block_repeat(A.to(dtype), (ed - st) // 4)))
        elif name == "so3":
            # Wigner-D blocks of degrees 1..n, detached (reference gta.py:194-197):
            # orthogonal, so the inverse-transpose for 'q' is D itself and the
            # inverse for 'out' is D^T
            Ds = reps.so3_q if side in ("q", "out") else reps.so3_k
            blocks = [D.detach().to(dtype) for D in Ds]
            if side == "out":
                blocks = [D.transpose(-1, -2) for D in blocks]
            total = sum(D.shape[-1] for D in blocks)
            stack = torch.zeros((*blocks[0].shape[:2], total, total), dtype=dtype, device=blocks[0].device)
            cur = 0
            for D in blocks:
                d = D.shape[-1]
                stack[:, :, cur : cur + d, cur : cur + d] = D
                cur += d
            parts.append((st, ed, _block_repeat(stack, (ed - st) // total)))
    if not parts:
        return None
    B, N = parts[0][2].shape[:2]
    M = torch.zeros((B, N, C, C), dtype=dtype, device=parts[0][2].device)
    for name, st, ed in fd.slices():
        if name in ("triv", "so2"):
            idx = torch.arange(st, ed, device=M.device)
            M[:, :, idx, idx] = 1.0
    for st, ed, p in parts:
        M[:, :, st:ed, st:ed] = p
    return M


def _apply_blockdiag(M: torch.Tensor, x: torch.Tensor, n_views: int) -> torch.Tensor:
    B, H, T, C = x.shape
    xr = x.reshape(B, H, n_views, T // n_views, C)
    y = torch.einsum("bnij,bhntj->bhnti", M, xr)
    return y.reshape(B, H, T, C)


def _apply_so2_fullwidth(rotors, fd, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    cos, sin = _fw_rotors(rotors, fd, x.dtype)
    B, H, T, C = x.shape
    xr = x.reshape(B, H, T, C // 2, 2)
    fn = apply_rotor_inv if inverse else apply_rotor
    return fn(cos[:, None], sin[:, None], xr).reshape(B, H, T, C)


def _view_counts(reps: GeomReps) -> Tuple[Optional[int], Optional[int]]:
    """Query/key view counts from rep table shapes (the se3 tables, else the
    so3 ones)."""
    nq = nk = None
    if reps.se3_q is not None:
        nq = reps.se3_q.shape[1]
    elif reps.so3_q is not None:
        nq = reps.so3_q[0].shape[1]
    if reps.se3_k is not None:
        nk = reps.se3_k.shape[1]
    elif reps.so3_k is not None:
        nk = reps.so3_k[0].shape[1]
    return nq, nk


def _require_blockdiag(reps: GeomReps, args: GTAArgs):
    if not _blockdiag_ok(reps, args):
        raise NotImplementedError(
            "sliced GTA (t2 / euclid / per-token SE(3) / odd spans) is not ported yet "
            "(ROADMAP queue 1, other attention methods)"
        )


def gta_transform_qkv(q, k, v, reps: GeomReps, args: GTAArgs, trans_coeff):
    """Apply group reps to (q, k, v) [B, H, T, C] in block-diagonal form."""
    _require_blockdiag(reps, args)
    fd = args.f_dims
    nq, nk = _view_counts(reps)
    Mq = _blockdiag_mat(reps, args, trans_coeff, "q", q.dtype)
    Mk = _blockdiag_mat(reps, args, trans_coeff, "k", k.dtype)
    qt = _apply_blockdiag(Mq, q, nq) if Mq is not None else q
    kt = _apply_blockdiag(Mk, k, nk) if Mk is not None else k
    vt = v
    if args.v_transform and Mk is not None:
        vt = _apply_blockdiag(Mk, v, nk)
    if reps.so2_q is not None:
        qt = _apply_so2_fullwidth(reps.so2_q, fd, qt)
    if reps.so2_k is not None:
        kt = _apply_so2_fullwidth(reps.so2_k, fd, kt)
        if args.v_transform:
            vt = _apply_so2_fullwidth(reps.so2_k, fd, vt)
    return qt, kt, vt


def gta_untransform_out(out, reps: GeomReps, args: GTAArgs, trans_coeff):
    """Apply the inverse query rep to the attention output (v_transform only)."""
    _require_blockdiag(reps, args)
    nq, _ = _view_counts(reps)
    Mo = _blockdiag_mat(reps, args, trans_coeff, "out", out.dtype)
    o = _apply_blockdiag(Mo, out, nq) if Mo is not None else out
    if reps.so2_q is not None:
        o = _apply_so2_fullwidth(reps.so2_q, args.f_dims, o, inverse=True)
    return o


def gta_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_fn: AttnFn,
    reps: GeomReps,
    args: GTAArgs,
    trans_coeff: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full GTA attention: transform -> attend -> untransform.

    q: [B, H, Tq, C], k/v: [B, H, Tk, C] with C == args.f_dims.total.
    attn_fn(qt, kt, vt) -> (out, attn).
    """
    if q.shape[-1] != args.f_dims.total:
        raise ValueError(f"head dim {q.shape[-1]} != f_dims total {args.f_dims.total}")
    qt, kt, vt = gta_transform_qkv(q, k, v, reps, args, trans_coeff)
    out, attn = attn_fn(qt, kt, vt)
    if args.v_transform:
        out = gta_untransform_out(out, reps, args, trans_coeff)
    return out, attn
