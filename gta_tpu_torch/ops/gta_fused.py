"""Fully fused GTA attention forward: rep transforms inside the kernel.

Port of gta_tpu/ops/gta_fused.py (`_fwd_kernel` and its dispatch through
ops/gta_pallas.fused_gta_attention). Operands arrive token-major
[B, T, H*C], as the q/k/v projections produce them. The per-view group
action (SE(3) vec4 blocks composed into one [C, C] block-diagonal matrix per
view by ops/gta._blockdiag_mat) is applied as a row-vector product
`x @ M` with M = (left matrix)^T; the per-token SO(2) rotors ride
full-width, identity-padded per-lane (cos, sin) tables; the output inverse
rep applies before the store.

Dispatch, with no fallbacks: a CPU tensor takes the plain PyTorch version
(`gta_fused_fwd_plain`); a CUDA tensor launches the hand-written kernel
(csrc/gta_fused_fwd.cu) or raises. Calls the kernel does not cover raise
NotImplementedError naming their ROADMAP item, on every device.

Precision: fp32 throughout, fp32 FMA on the CUDA cores (the Pallas kernel
rounds matmul operands to bf16 on the TPU; its fp32 interpret mode is what
the port is held to).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.ops import _cuda
from gta_tpu_torch.ops.gta import _blockdiag_mat, _blockdiag_ok, _fw_rotors, _view_counts
from gta_tpu_torch.ops.reps import GeomReps

KERNEL_HEAD_DIM = 64  # the head width the CUDA kernel is compiled for

# flag bits of the C interface (csrc/gta_fused_fwd.cu)
_HAS_MQ, _HAS_MK, _HAS_MO, _HAS_ROTQ, _HAS_ROTK, _V_TRANSFORM = 1, 2, 4, 8, 16, 32


@dataclasses.dataclass
class FusedTables:
    """Per-call rep tables in the kernel's form.

    m*: [B, N, C, C] row-vector matrices (x_row @ M), or None for identity.
    c*/s*: [B, T, C] per-lane rotor tables (each rotor on both lanes of its
    pair), or None when the call has no SO(2) span.
    """

    mq: Optional[torch.Tensor]
    mk: Optional[torch.Tensor]
    mo: Optional[torch.Tensor]
    cq: Optional[torch.Tensor]
    sq: Optional[torch.Tensor]
    ck: Optional[torch.Tensor]
    sk: Optional[torch.Tensor]
    nq: int
    nk: int
    v_transform: bool


def _expand_rotors(rotors, fd):
    """Identity-padded (cos, sin) [B, T, C/2] -> per-lane [B, T, C]."""
    cos, sin = _fw_rotors(rotors, fd, torch.float32)
    return (
        cos.repeat_interleave(2, -1).contiguous(),
        sin.repeat_interleave(2, -1).contiguous(),
    )


def check_supported(reps: GeomReps, args: GTAArgs, Tq: int, Tk: int) -> None:
    """Raise NotImplementedError for calls the fused forward does not cover.

    The Pallas kernel's limits (whole K/V in VMEM up to 2048 keys, 8-row
    aligned query blocks) do not apply: the port tiles K with an online
    softmax and finds each row's view from its index.
    """
    if args.elementwise_mul or not _blockdiag_ok(reps, args):
        raise NotImplementedError(
            "GTA with t2 / euclid / elementwise_mul / per-token SE(3) reps has no fused "
            "kernel yet (ROADMAP queue 2, flash_core port, and queue 1, other attention methods)"
        )
    nq, nk = _view_counts(reps)
    if Tq % (nq or 1) or Tk % (nk or 1):
        raise ValueError(f"token counts ({Tq}, {Tk}) do not divide into views ({nq}, {nk})")


def fused_tables(reps: GeomReps, args: GTAArgs, trans_coeff: Optional[torch.Tensor]) -> FusedTables:
    """Compose the kernel's tables for one attention call."""
    f32 = torch.float32
    nq, nk = _view_counts(reps)
    Bq = _blockdiag_mat(reps, args, trans_coeff, "q", f32)
    Bk = _blockdiag_mat(reps, args, trans_coeff, "k", f32)
    Bo = _blockdiag_mat(reps, args, trans_coeff, "out", f32) if args.v_transform else None
    row = lambda M: None if M is None else M.transpose(-1, -2).contiguous()  # noqa: E731
    cq = sq = ck = sk = None
    if reps.so2_q is not None:
        cq, sq = _expand_rotors(reps.so2_q, args.f_dims)
    if reps.so2_k is not None:
        ck, sk = _expand_rotors(reps.so2_k, args.f_dims)
    return FusedTables(
        mq=row(Bq), mk=row(Bk), mo=row(Bo), cq=cq, sq=sq, ck=ck, sk=sk,
        nq=nq or 1, nk=nk or 1, v_transform=bool(args.v_transform),
    )


def _pair_swap_neg(z: torch.Tensor) -> torch.Tensor:
    """(x0, x1) lane pairs -> (-x1, x0)."""
    zp = z.reshape(*z.shape[:-1], -1, 2)
    return torch.stack((-zp[..., 1], zp[..., 0]), -1).reshape(z.shape)


def gta_fused_fwd_plain(
    qB: torch.Tensor, kB: torch.Tensor, vB: torch.Tensor, t: FusedTables, heads: int, scale: float
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function of the same
    inputs, as per-view einsums over the block-diagonal matrices and
    full-width rotors. q [B, Tq, H*C], k/v [B, Tk, H*C] -> [B, Tq, H*C]."""
    B, Tq, D = qB.shape
    Tk = kB.shape[1]
    C = D // heads

    def heads_first(x, T):
        return x.reshape(B, T, heads, C).transpose(1, 2)  # [B, H, T, C]

    def per_view(x, M, n):  # x_row @ M[view]
        return torch.einsum("bhntc,bncd->bhntd", x.reshape(B, heads, n, -1, C), M).reshape(x.shape)

    def rot(x, c, s, sign):
        return c[:, None] * x + sign * s[:, None] * _pair_swap_neg(x)

    q, k, v = heads_first(qB, Tq), heads_first(kB, Tk), heads_first(vB, Tk)
    qt = per_view(q, t.mq, t.nq) if t.mq is not None else q
    if t.cq is not None:
        qt = rot(qt, t.cq, t.sq, 1.0)
    kt, vt = k, v
    if t.mk is not None:
        kt = per_view(k, t.mk, t.nk)
        if t.v_transform:
            vt = per_view(v, t.mk, t.nk)
    if t.ck is not None:
        kt = rot(kt, t.ck, t.sk, 1.0)
        if t.v_transform:
            vt = rot(vt, t.ck, t.sk, 1.0)
    sim = torch.einsum("bhqc,bhkc->bhqk", qt, kt) * scale
    p = torch.softmax(sim.float(), dim=-1)
    o = torch.einsum("bhqk,bhkc->bhqc", p, vt)
    if t.v_transform:
        if t.mo is not None:
            o = per_view(o, t.mo, t.nq)
        if t.cq is not None:
            o = rot(o, t.cq, t.sq, -1.0)
    return o.transpose(1, 2).reshape(B, Tq, D)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _bind():
    lib = _cuda.load("gta_fused_fwd")
    fn = lib.gta_fused_fwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gta_fused_error_string.argtypes = [ctypes.c_int]
    lib.gta_fused_error_string.restype = ctypes.c_char_p
    return lib


def gta_fused_fwd(
    qB: torch.Tensor, kB: torch.Tensor, vB: torch.Tensor, t: FusedTables, heads: int, scale: float
) -> torch.Tensor:
    """Fused GTA attention forward over token-major operands.

    CPU tensors take `gta_fused_fwd_plain`; CUDA tensors launch the kernel
    or raise. `gta_fused_fwd.launches` counts launches of the C entry
    point: each one runs the K/V prologue kernel (when K/V have a
    transform) and then the main kernel, so the card sees up to two
    kernel launches per count.
    """
    if qB.device.type == "cpu":
        return gta_fused_fwd_plain(qB, kB, vB, t, heads, scale)
    if qB.device.type != "cuda":
        raise NotImplementedError(f"no fused GTA kernel for device {qB.device}")
    tables = [t.mq, t.mk, t.mo, t.cq, t.sq, t.ck, t.sk]
    operands = [qB, kB, vB] + [x for x in tables if x is not None]
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        raise NotImplementedError(
            "the fused GTA backward kernel is not ported yet (ROADMAP queue 2, _bwd_kernel)"
        )
    B, Tq, D = qB.shape
    Tk = kB.shape[1]
    C = D // heads
    if C != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA kernel is built for head dim {KERNEL_HEAD_DIM}, got {C} "
            "(ROADMAP queue 1, msn_so3 slice and other configs)"
        )
    for x in operands:
        if x.device != qB.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("fused GTA kernel operands must be contiguous fp32 on one CUDA device")
    if kB.shape != (B, Tk, D) or vB.shape != (B, Tk, D) or D != heads * C:
        raise ValueError(f"bad operand shapes q {tuple(qB.shape)} k {tuple(kB.shape)} v {tuple(vB.shape)}")
    if Tq % t.nq or Tk % t.nk:
        raise ValueError(f"token counts ({Tq}, {Tk}) do not divide into views ({t.nq}, {t.nk})")

    flags = (
        (_HAS_MQ if t.mq is not None else 0)
        | (_HAS_MK if t.mk is not None else 0)
        | (_HAS_MO if t.mo is not None else 0)
        | (_HAS_ROTQ if t.cq is not None else 0)
        | (_HAS_ROTK if t.ck is not None else 0)
        | (_V_TRANSFORM if t.v_transform else 0)
    )
    kv_transform = t.mk is not None or t.ck is not None
    kt = torch.empty((B, heads, Tk, C), dtype=torch.float32, device=qB.device) if kv_transform else None
    vt = (
        torch.empty((B, heads, Tk, C), dtype=torch.float32, device=qB.device)
        if kv_transform and t.v_transform else None
    )
    out = torch.empty_like(qB)
    lib = _bind()
    stream = torch.cuda.current_stream(qB.device).cuda_stream
    with torch.cuda.device(qB.device):
        err = lib.gta_fused_fwd(
            _ptr(qB), _ptr(kB), _ptr(vB), _ptr(t.mq), _ptr(t.mk), _ptr(t.mo),
            _ptr(t.cq), _ptr(t.sq), _ptr(t.ck), _ptr(t.sk), _ptr(kt), _ptr(vt), _ptr(out),
            B, heads, Tq, Tk, C, t.nq, t.nk, flags, float(scale), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"gta_fused_fwd launch failed: {lib.gta_fused_error_string(err).decode()}")
    gta_fused_fwd.launches += 1
    return out


gta_fused_fwd.launches = 0


def fused_gta_attention_tokens(
    qB: torch.Tensor,
    kB: torch.Tensor,
    vB: torch.Tensor,
    heads: int,
    reps: GeomReps,
    args: GTAArgs,
    trans_coeff: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """GTA attention over token-major [B, T, H*C] operands (the layer's entry)."""
    check_supported(reps, args, qB.shape[1], kB.shape[1])
    t = fused_tables(reps, args, trans_coeff)
    return gta_fused_fwd(qB.contiguous(), kB.contiguous(), vB.contiguous(), t, heads, scale)

