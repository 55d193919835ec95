"""Geometric transform attention (GTA) — plain PyTorch reference form.

Semantics match reference gta.py:92-279: each head's channel dim is split
into group-typed slices; Q is left-multiplied by the inverse-transpose rep,
K and V by the forward rep; softmax attention runs on the transformed
triple; the inverse query rep is applied to the output.

Two forms, as in gta_tpu/ops/gta.py:
  * block-diagonal, where it applies: all per-VIEW group factors (SE(3)
    vec4 blocks, SO(3) Wigner-D blocks, identity on triv and so2 spans)
    compose into one [C, C] matrix per view, and the per-TOKEN SO(2) rotors
    ride one full-width RoPE pass with identity (cos=1, sin=0) padding
    outside the so2 span. It is the oracle the fused kernel
    (ops/gta_fused.py) is checked against.
  * sliced, for the rep mixes a per-view matrix cannot express: per-token
    SE(3) tables (ray_to_se3), T(2) per-token 3x3s and euclid_sim's
    homogenized 3-vectors. Each group's channel slice is transformed on
    its own and the slices are concatenated.
`vecrep_attention` is the elementwise_mul ablation (reference
gta.py:282-298).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.geometry.se3 import homogenize, scale_mask
from gta_tpu_torch.geometry.so2 import apply_rotor, apply_rotor_inv
from gta_tpu_torch.ops.reps import GeomReps

AttnFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
_SAME = object()  # gta_transform_qkv's default key-side trans_coeff: the query side's


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


def _table_dtype(reps: GeomReps, dtype: torch.dtype) -> torch.dtype:
    """The dtype the sliced form computes in: its rep tables' (fp32)
    promoted with the operands' `dtype`."""
    for f in dataclasses.fields(reps):
        table = getattr(reps, f.name)
        table = table[0] if isinstance(table, tuple) else table
        if table is not None:
            return torch.promote_types(table.dtype, dtype)
    return dtype


def sliced_operand(x: Optional[torch.Tensor], reps: GeomReps) -> Optional[torch.Tensor]:
    """x promoted once to the sliced form's compute dtype (`_table_dtype`):
    a bf16 operand enters the fp32 chain of transforms once, so its
    cotangent, summed in fp32 over every use in the chain, rounds once (a
    TPU's fused chain), not once per use and then again in the bf16 sum."""
    return x if x is None else x.to(_table_dtype(reps, x.dtype))


def _promote(A: torch.Tensor, x: torch.Tensor):
    """(A, x) in their common dtype: the sliced form computes in the
    tables' fp32 whatever the compute dtype, as jnp.einsum promotes (so a
    bf16 model's transformed slices are fp32, gta_tpu/ops/gta.py:404-449)."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return A.to(dt), x.to(dt)


def _apply_mat(A: torch.Tensor, x: torch.Tensor, n_views: int, d: int) -> torch.Tensor:
    """Left-multiply channel d-vectors of x [B, H, N*T', C] by per-view
    matrices A [B, N, d, d] or per-view-token ones [B, N, T', d, d]."""
    A, x = _promote(A, x)
    B, H, T, C = x.shape
    xr = x.reshape(B, H, n_views, T // n_views, C // d, d)
    eq = "bnij,bhntcj->bhntci" if A.ndim == 4 else "bntij,bhntcj->bhntci"
    return torch.einsum(eq, A, xr).reshape(B, H, T, C)


def _apply_mat_per_token(A: torch.Tensor, x: torch.Tensor, d: int) -> torch.Tensor:
    """Left-multiply channel d-vectors of x [B, H, T, C] by per-token
    matrices A [B, T, d, d]."""
    A, x = _promote(A, x)
    B, H, T, C = x.shape
    return torch.einsum("btij,bhtcj->bhtci", A, x.reshape(B, H, T, C // d, d)).reshape(B, H, T, C)


def _apply_euclid(A: torch.Tensor, x: torch.Tensor, n_views: int) -> torch.Tensor:
    """euclid_sim: homogenize channel 3-vectors, push them through the
    [.., 4, 4] matrices A, keep the first three rows."""
    A, x = _promote(A, x)
    B, H, T, C = x.shape
    xr = homogenize(x.reshape(B, H, n_views, T // n_views, C // 3, 3))
    eq = "bnij,bhntcj->bhntci" if A.ndim == 4 else "bntij,bhntcj->bhntci"
    return torch.einsum(eq, A, xr)[..., :3].reshape(B, H, T, C)


def _apply_so3(Ds, x: torch.Tensor, n_views: int, transpose: bool = False) -> torch.Tensor:
    """Per-view block-diagonal Wigner-D stacks Ds (degrees 1..n, each
    [B, N, 2l+1, 2l+1], detached as the reference does, gta.py:194-197) on
    x [B, H, N*T', C]; token and channel axes merge per view (reference
    gta.py:182-186)."""
    B, H, T, C = x.shape
    total = sum(D.shape[-1] for D in Ds)
    xr = x.reshape(B, H, n_views, (T // n_views) * (C // total), total)
    outs, cur = [], 0
    for D in Ds:
        d = D.shape[-1]
        D, xs = _promote(D.detach(), xr[..., cur : cur + d])
        if transpose:
            D = D.transpose(-1, -2)
        outs.append(torch.einsum("bnij,bhnkj->bhnki", D, xs))
        cur += d
    return torch.cat(outs, -1).reshape(B, H, T, C)


def _apply_so2(rotors, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """RoPE-style rotors (cos, sin) [B, T, R] on x [B, H, T, 2R]."""
    cos, sin = rotors
    B, H, T, C = x.shape
    fn = apply_rotor_inv if inverse else apply_rotor
    return fn(cos[:, None], sin[:, None], x.reshape(B, H, T, C // 2, 2)).reshape(B, H, T, C)


def _transform_sliced(q, k, v, reps: GeomReps, args: GTAArgs, trans_coeff, trans_coeff_k=_SAME):
    """The sliced form of `gta_transform_qkv` (gta_tpu/ops/gta.py:404-449)."""
    if trans_coeff_k is _SAME:
        trans_coeff_k = trans_coeff
    nq, nk = _view_counts(reps)
    vt = args.v_transform
    q, k = sliced_operand(q, reps), sliced_operand(k, reps)
    v = sliced_operand(v, reps) if vt else v
    qs, ks, vs = [], [], []
    for name, st, ed in args.f_dims.slices():
        q_s, k_s, v_s = q[..., st:ed], k[..., st:ed], v[..., st:ed]
        if name == "se3":
            msk = scale_mask(trans_coeff if trans_coeff is not None else 1.0, q.dtype, q.device)
            msk_k = scale_mask(trans_coeff_k if trans_coeff_k is not None else 1.0, q.dtype, q.device)
            c_q, c_k, inv_c_q = reps.se3_q * msk, reps.se3_k * msk_k, reps.se3_q_inv * msk
            if args.euclid_sim:
                q_s, k_s = _apply_euclid(c_q, q_s, nq), _apply_euclid(c_k, k_s, nk)
                v_s = _apply_euclid(c_k, v_s, nk) if vt else v_s
            else:
                q_s, k_s = _apply_mat(inv_c_q.transpose(-1, -2), q_s, nq, 4), _apply_mat(c_k, k_s, nk, 4)
                v_s = _apply_mat(c_k, v_s, nk, 4) if vt else v_s
        elif name == "so3":
            q_s, k_s = _apply_so3(reps.so3_q, q_s, nq), _apply_so3(reps.so3_k, k_s, nk)
            v_s = _apply_so3(reps.so3_k, v_s, nk) if vt else v_s
        elif name == "so2":
            q_s, k_s = _apply_so2(reps.so2_q, q_s), _apply_so2(reps.so2_k, k_s)
            v_s = _apply_so2(reps.so2_k, v_s) if vt else v_s
        elif name == "t2":
            q_s = _apply_mat_per_token(reps.t2_q_inv.transpose(-1, -2), q_s, 3)
            k_s = _apply_mat_per_token(reps.t2_k, k_s, 3)
            v_s = _apply_mat_per_token(reps.t2_k, v_s, 3) if vt else v_s
        qs.append(q_s)
        ks.append(k_s)
        vs.append(v_s)
    return _cat(qs), _cat(ks), _cat(vs)


def _untransform_sliced(out, reps: GeomReps, args: GTAArgs, trans_coeff):
    """The sliced form of `gta_untransform_out` (gta_tpu/ops/gta.py:473-501)."""
    nq, _ = _view_counts(reps)
    outs = []
    for name, st, ed in args.f_dims.slices():
        o = out[..., st:ed]
        if name == "se3":
            msk = scale_mask(trans_coeff if trans_coeff is not None else 1.0, out.dtype, out.device)
            inv_c_q = reps.se3_q_inv * msk
            o = _apply_euclid(inv_c_q, o, nq) if args.euclid_sim else _apply_mat(inv_c_q, o, nq, 4)
        elif name == "so3":
            o = _apply_so3(reps.so3_q, o, nq, transpose=True)
        elif name == "so2":
            o = _apply_so2(reps.so2_q, o, inverse=True)
        elif name == "t2":
            o = _apply_mat_per_token(reps.t2_q_inv, o, 3)
        outs.append(o)
    return _cat(outs)


def _cat(parts):
    """Concatenate channel slices in their promoted dtype (jnp.concatenate's
    rule)."""
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.to(dt) for p in parts], -1)


def gta_transform_qkv(q, k, v, reps: GeomReps, args: GTAArgs, trans_coeff, trans_coeff_k=_SAME):
    """Apply group reps to (q, k, v) [B, H, T, C]: the block-diagonal form
    where it applies, else the sliced one. `trans_coeff_k`, where given,
    scales the key side's SE(3) tables in place of `trans_coeff` (the same
    value, whose gradient the ring sums apart: parallel/ring.py)."""
    if trans_coeff_k is _SAME:
        trans_coeff_k = trans_coeff
    if not _blockdiag_ok(reps, args):
        return _transform_sliced(q, k, v, reps, args, trans_coeff, trans_coeff_k)
    fd = args.f_dims
    nq, nk = _view_counts(reps)
    Mq = _blockdiag_mat(reps, args, trans_coeff, "q", q.dtype)
    Mk = _blockdiag_mat(reps, args, trans_coeff_k, "k", k.dtype)
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
    """Apply the inverse query rep to the attention output (v_transform only),
    in the form `gta_transform_qkv` takes."""
    if not _blockdiag_ok(reps, args):
        return _untransform_sliced(out, reps, args, trans_coeff)
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
    if not _blockdiag_ok(reps, args):  # one promotion of the coefficient for both sides of the chain
        trans_coeff = sliced_operand(trans_coeff, reps)
    qt, kt, vt = gta_transform_qkv(q, k, v, reps, args, trans_coeff)
    out, attn = attn_fn(qt, kt, vt)
    if args.v_transform:
        out = gta_untransform_out(out, reps, args, trans_coeff)
    return out, attn


def vecrep_attention(q, k, v, attn_fn: AttnFn, vec_q, vec_k, vec_q_inv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise-mul ablation (reference gta.py:282-298): q, k, v
    [B, H, T, C] scaled channelwise by learned projections vec_* [B, T, C]
    of the flattened reps, broadcast over heads; the output by vec_q_inv."""
    out, attn = attn_fn(vec_q[:, None] * q, vec_k[:, None] * k, vec_k[:, None] * v)
    return vec_q_inv[:, None] * out, attn
