"""Fully fused GTA attention, forward and backward: rep transforms inside
the kernels.

Port of gta_tpu/ops/gta_fused.py (`_fwd_kernel`, `_bwd_kernel` and the VJP
glue `_core_fwd`/`_core_bwd`), reached through the port's
ops/gta_pallas.fused_gta_attention where the reps are block-diagonal. Operands arrive token-major
[B, T, H*C], as the q/k/v projections produce them. The per-view group
action (SE(3) vec4 blocks composed into one [C, C] block-diagonal matrix per
view by ops/gta._blockdiag_mat) is applied as a row-vector product
`x @ M` with M = (left matrix)^T; the per-token SO(2) rotors ride
full-width, identity-padded per-lane (cos, sin) tables; the output inverse
rep applies before the store.

Dispatch, with no fallbacks: a CPU tensor takes the plain PyTorch versions
(`gta_fused_fwd_plain`, `gta_fused_bwd_plain`); a CUDA tensor launches the
hand-written kernels (csrc/gta_fused_fwd.cu, csrc/gta_fused_bwd.cu, built
for head widths 32, 64, 96 and 128, an fp32 and a bf16 instance each) or
raises. Any other multiple of 8 in [32, 128] runs in the next width up
(ops/_cuda.py `kernel_head_dim`): q, k, v (and the cotangent) zero-padded
per head, the per-view matrices padded with zero blocks and the rotor
tables with zeros, so the padded columns stay zero through every transform
and add nothing to a score; the results are cut back to C.
With grad enabled and an operand that requires it, the call goes
through `GTAFusedAttention`, whose backward is the backward kernel; rotor
tables get no cotangent, and autograd carries the matrix cotangents back
through the table construction to `trans_coeff`. Calls the kernels do not
cover raise (the dispatch in ops/gta_pallas.py sends them elsewhere), on
every device.

Precision, by the dtype of q, k and v (the JAX package's rules,
gta_tpu/ops/gta_fused.py:384, :441-452): the rep tables are fp32 whatever
the compute dtype; the output and dq, dk, dv take their inputs' dtype, the
matrix cotangents are fp32.
  * fp32: fp32 accuracy throughout. The kernels run the attention core and
    the per-view C x C transforms on the tensor cores as 3xTF32 (each fp32
    operand split into two TF32 parts, three products summed in fp32;
    csrc/tf32x3.cuh), the rotors and the softmax in fp32 on the CUDA cores.
  * bf16: the TPU kernel's rounding. The core's products take bf16
    operands (qt, kt and vt centred on their means, do, P, dS) with fp32
    accumulation (wgmma fed by TMA, csrc/attn_sm90.cuh), and so do the
    per-view C x C transforms (the row and the matrix rounded to bf16,
    csrc/gta_rows.cuh) and the matrix cotangents' reductions; the rotors,
    the softmax, lse and delta stay fp32.
The plain versions compute in fp32 from operands of either dtype (fp64 for
fp64 ones), the Pallas kernel's interpret mode; `mxu_dtype=torch.bfloat16`
rounds every product's operands to bf16 as the TPU kernel does
(`_dot(..., mxu_dtype)`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.ops import _cuda
from gta_tpu_torch.ops.flash_core import work_dtype
from gta_tpu_torch.ops.gta import _blockdiag_mat, _blockdiag_ok, _fw_rotors, _view_counts
from gta_tpu_torch.ops.reps import GeomReps

_DM_ROWS = 32  # rows per staging step of the backward's dM reduction (csrc/gta_fused_bwd.cu)

# flag bits of the C interfaces (csrc/gta_fused_fwd.cu, csrc/gta_fused_bwd.cu)
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
    """Raise ValueError for calls the fused kernels do not cover: t2,
    euclid, elementwise_mul, per-token SE(3) reps and odd spans beside
    rotors, which ops/gta_pallas.fused_gta_attention routes to the sliced
    transforms and flash_core (or the layer to torch eager).

    The Pallas kernel's limits (whole K/V in VMEM up to 2048 keys, 8-row
    aligned query blocks) do not apply: the port tiles K with an online
    softmax and finds each row's view from its index.
    """
    if args.elementwise_mul or not _blockdiag_ok(reps, args):
        raise ValueError(
            "GTA with t2 / euclid / elementwise_mul / per-token SE(3) reps has no fused kernel: "
            "ops/gta_pallas.fused_gta_attention routes it to the sliced transforms and flash_core"
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


class _Plain:
    """Layout helpers of the plain versions for one call: heads-first
    [B, H, T, C] views of token-major [B, T, H*C] operands, per-view
    products and the full-width rotors. Every product goes through `dot`,
    which rounds its operands to `mxu_dtype` when that is bf16 (the TPU
    kernel's `_dot`) and sums in the working dtype `work`."""

    def __init__(self, B: int, heads: int, C: int, work: torch.dtype, mxu_dtype: Optional[torch.dtype]):
        self.B, self.H, self.C = B, heads, C
        self.work = work
        self.round = mxu_dtype == torch.bfloat16

    def op(self, x):
        """x as a product operand."""
        return x.to(torch.bfloat16).to(self.work) if self.round else x.to(self.work)

    def dot(self, eq, a, b):
        return torch.einsum(eq, self.op(a), self.op(b))

    def heads_first(self, x, T):
        return x.reshape(self.B, T, self.H, self.C).transpose(1, 2).to(self.work)

    def tokens(self, x):
        return x.transpose(1, 2).reshape(self.B, x.shape[2], self.H * self.C)

    def per_view(self, x, M, n, transpose=False):  # x_row @ M[view] (or M[view]^T)
        eq = "bhntc,bndc->bhntd" if transpose else "bhntc,bncd->bhntd"
        return self.dot(eq, x.reshape(self.B, self.H, n, -1, self.C), M).reshape(x.shape)

    def dmat(self, x, y, n):  # sum over heads and a view's rows of x^T y -> [B, n, C, C]
        shape = (self.B, self.H, n, -1, self.C)
        return self.dot("bhntc,bhntd->bncd", x.reshape(shape), y.reshape(shape))

    def rot(self, x, c, s, sign):
        return c[:, None].to(self.work) * x + sign * s[:, None].to(self.work) * _pair_swap_neg(x)

    def transform(self, q, k, v, t: FusedTables):
        """(qt, kt, vt) of heads-first q, k, v: _transform_sides."""
        qt = self.per_view(q, t.mq, t.nq) if t.mq is not None else q
        if t.cq is not None:
            qt = self.rot(qt, t.cq, t.sq, 1.0)
        kt, vt = k, v
        if t.mk is not None:
            kt = self.per_view(k, t.mk, t.nk)
            if t.v_transform:
                vt = self.per_view(v, t.mk, t.nk)
        if t.ck is not None:
            kt = self.rot(kt, t.ck, t.sk, 1.0)
            if t.v_transform:
                vt = self.rot(vt, t.ck, t.sk, 1.0)
        return qt, kt, vt


def gta_fused_fwd_plain(
    qB: torch.Tensor,
    kB: torch.Tensor,
    vB: torch.Tensor,
    t: FusedTables,
    heads: int,
    scale: float,
    store_z: bool = False,
    mxu_dtype: Optional[torch.dtype] = None,
):
    """Plain PyTorch version of the forward kernel: the same function of the
    same inputs, as per-view einsums over the block-diagonal matrices and
    full-width rotors (with bf16 operands as `_fwd_kernel` computes it:
    o = (e vt) / rowsum(e), e = exp(s - max)). q [B, Tq, H*C], k/v [B, Tk, H*C] ->
    [B, Tq, H*C] in q's dtype; with `store_z`, (out, z) where z is the
    output before the output transform (the Pallas kernel's `store_z`), in
    q's dtype too. `mxu_dtype=torch.bfloat16` rounds every product's
    operands to bf16 (see the module docstring)."""
    B, Tq, D = qB.shape
    Tk = kB.shape[1]
    P = _Plain(B, heads, D // heads, work_dtype(qB), mxu_dtype)
    qt, kt, vt = P.transform(P.heads_first(qB, Tq), P.heads_first(kB, Tk), P.heads_first(vB, Tk), t)
    sim = P.dot("bhqc,bhkc->bhqk", qt, kt) * scale
    if P.round:  # the TPU kernel rounds e = exp(s - max) for the product, then divides
        e = torch.exp(sim - sim.amax(-1, keepdim=True))
        z = P.dot("bhqk,bhkc->bhqc", e, vt) / e.sum(-1, keepdim=True)
    else:
        z = torch.einsum("bhqk,bhkc->bhqc", torch.softmax(sim, dim=-1), vt)
    o = z
    if t.v_transform:
        if t.mo is not None:
            o = P.per_view(o, t.mo, t.nq)
        if t.cq is not None:
            o = P.rot(o, t.cq, t.sq, -1.0)
    out = P.tokens(o).to(qB.dtype)
    return (out, P.tokens(z).to(qB.dtype)) if store_z else out


def gta_fused_bwd_plain(
    qB: torch.Tensor,
    kB: torch.Tensor,
    vB: torch.Tensor,
    t: FusedTables,
    heads: int,
    scale: float,
    g: torch.Tensor,
    z: torch.Tensor,
    mxu_dtype: Optional[torch.dtype] = None,
    keep: Optional[dict] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel: `_bwd_kernel`'s
    formulas written out (recompute the transformed triple and the softmax,
    then the output, core, query and key/value chains).

    g: the cotangent of the forward's output, z: its `store_z` output, both
    [B, Tq, H*C]. Returns (dq, dk, dv, dmq, dmk, dmo) in the kernel's
    layouts: token-major dq/dk/dv in their inputs' dtype, per-view
    [B, N, C, C] matrix cotangents summed over heads, fp32 (fp64 for fp64
    operands; None where the table is absent). `mxu_dtype` as in
    `gta_fused_fwd_plain`. `keep`, a dict, receives the chains' inputs
    dz, dzq, dzk, dzv (token-major, where present): the core's dqt, dkt,
    dvt after the inverse rotors."""
    B, Tq, D = qB.shape
    Tk = kB.shape[1]
    P = _Plain(B, heads, D // heads, work_dtype(qB), mxu_dtype)
    q0, k0, v0 = P.heads_first(qB, Tq), P.heads_first(kB, Tk), P.heads_first(vB, Tk)
    qt, kt, vt = P.transform(q0, k0, v0, t)
    s = P.dot("bhqc,bhkc->bhqk", qt, kt) * scale
    p = torch.softmax(s, dim=-1)
    gh = P.heads_first(g, Tq)

    # output chain: out = rot_q^-1(z @ Mo)
    dmq = dmk = dmo = None
    if t.v_transform:
        dz = P.rot(gh, t.cq, t.sq, 1.0) if t.cq is not None else gh
        if t.mo is not None:
            do = P.per_view(dz, t.mo, t.nq, transpose=True)
            dmo = P.dmat(P.heads_first(z, Tq), dz, t.nq)
        else:
            do = dz
    else:
        do = gh

    # attention core
    dp = P.dot("bhqc,bhkc->bhqk", do, vt)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dqt = P.dot("bhqk,bhkc->bhqc", ds, kt)
    dkt = P.dot("bhqk,bhqc->bhkc", ds, qt)
    dvt = P.dot("bhqk,bhqc->bhkc", p, do)

    # query chain: qt = rot_q(q @ Mq)
    dzq = P.rot(dqt, t.cq, t.sq, -1.0) if t.cq is not None else dqt
    if t.mq is not None:
        dq = P.per_view(dzq, t.mq, t.nq, transpose=True)
        dmq = P.dmat(q0, dzq, t.nq)
    else:
        dq = dzq

    # key / value chain: kt = rot_k(k @ Mk), vt = rot_k(v @ Mk)
    dzk, dzv = dkt, dvt
    if t.ck is not None:
        dzk = P.rot(dkt, t.ck, t.sk, -1.0)
        if t.v_transform:
            dzv = P.rot(dvt, t.ck, t.sk, -1.0)
    dk, dv = dzk, dzv
    if t.mk is not None:
        dk = P.per_view(dzk, t.mk, t.nk, transpose=True)
        dmk = P.dmat(k0, dzk, t.nk)
        if t.v_transform:
            dv = P.per_view(dzv, t.mk, t.nk, transpose=True)
            dmk = dmk + P.dmat(v0, dzv, t.nk)
    if keep is not None:
        keep.update(dzq=P.tokens(dzq), dzk=P.tokens(dzk), dzv=P.tokens(dzv))
        if t.v_transform:
            keep["dz"] = P.tokens(dz)
    return (P.tokens(dq).to(qB.dtype), P.tokens(dk).to(kB.dtype), P.tokens(dv).to(vB.dtype),
            dmq, dmk, dmo)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _tables(t: FusedTables):
    return [t.mq, t.mk, t.mo, t.cq, t.sq, t.ck, t.sk]


def _flags(t: FusedTables) -> int:
    return (
        (_HAS_MQ if t.mq is not None else 0)
        | (_HAS_MK if t.mk is not None else 0)
        | (_HAS_MO if t.mo is not None else 0)
        | (_HAS_ROTQ if t.cq is not None else 0)
        | (_HAS_ROTK if t.ck is not None else 0)
        | (_V_TRANSFORM if t.v_transform else 0)
    )


def _pad_tables(t: FusedTables, C: int, width: int) -> FusedTables:
    """t at the instance width: each matrix [B, N, C, C] with zero blocks
    past C, each rotor table [B, T, C] with zero columns (t itself where C
    == width)."""
    if C == width:
        return t
    pad = lambda x, p: None if x is None else F.pad(x, p).contiguous()  # noqa: E731
    mats = (pad(m, (0, width - C, 0, width - C)) for m in (t.mq, t.mk, t.mo))
    rots = (pad(r, (0, width - C)) for r in (t.cq, t.sq, t.ck, t.sk))
    return FusedTables(*mats, *rots, t.nq, t.nk, t.v_transform)


def _check_kernel_call(name, qB, kB, vB, t: FusedTables, heads: int, same=(), f32=()):
    """Validate a kernel launch's operands: q, k, v and `same` (cotangent,
    residuals) contiguous in one dtype that an instance covers, the tables
    and `f32` (log-sum-exp) contiguous fp32, all on q's CUDA device.
    Returns (B, Tq, Tk, D, C, width): width the head width of the instance
    that runs C."""
    if qB.device.type != "cuda":
        raise NotImplementedError(f"no fused GTA kernel for device {qB.device}")
    B, Tq, D = qB.shape
    Tk = kB.shape[1]
    C = D // heads
    width = _cuda.kernel_head_dim(name, C)
    bad = ValueError(f"{name} operands must be contiguous fp32 (or bf16 beside fp32 tables) on one CUDA device")
    for x in [qB, kB, vB, *same]:
        if x.device != qB.device or x.dtype != qB.dtype or not x.is_contiguous():
            raise bad
    _cuda.check_kernel_dtype(name, qB.dtype)
    for x in [*f32] + [x for x in _tables(t) if x is not None]:
        if x.device != qB.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise bad
    if kB.shape != (B, Tk, D) or vB.shape != (B, Tk, D) or D != heads * C:
        raise ValueError(f"bad operand shapes q {tuple(qB.shape)} k {tuple(kB.shape)} v {tuple(vB.shape)}")
    if Tq % t.nq or Tk % t.nk:
        raise ValueError(f"token counts ({Tq}, {Tk}) do not divide into views ({t.nq}, {t.nk})")
    return B, Tq, Tk, D, C, width


def _bind(lib, fn_name: str, n_ptrs: int, n_ints: int, err_name: str):
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, err_name)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _bind_fwd(bf16: bool, width: int):
    lib = _cuda.load("gta_fused_fwd", width)
    if bf16:
        return _bind(lib, "gta_fused_fwd_bf16", 19, 8, "gta_fused_error_string")
    return _bind(lib, "gta_fused_fwd", 17, 8, "gta_fused_error_string")


def _bind_bwd(bf16: bool, width: int):
    lib = _cuda.load("gta_fused_bwd", width)
    if bf16:
        return _bind(lib, "gta_fused_bwd_bf16", 32, 10, "gta_fused_bwd_error_string")
    return _bind(lib, "gta_fused_bwd", 30, 10, "gta_fused_bwd_error_string")


@dataclasses.dataclass
class Residuals:
    """What the backward needs from its forward besides the inputs.

    z: [B, Tq, H*C], the output before the output transform (`store_z`;
    the output itself without v_transform), in q's dtype. The kernel's
    forward also keeps lse [B, H, Tq] (fp32), each row's log-sum-exp of the
    scaled scores, and its transformed Q/K/V scratch qt [B, H, Tq, C],
    kt/vt [B, H, Tk, C] (fp32: None where that side has no transform; bf16:
    kt and vt always, minus their means, and lse about kt minus its mean);
    the plain version recomputes them and leaves them None. The scratch
    is at the width of the instance that ran (the call's C zero-padded to
    it, ops/_cuda.py `kernel_head_dim`); z at the call's own.
    """

    z: torch.Tensor
    lse: Optional[torch.Tensor] = None
    kt: Optional[torch.Tensor] = None
    vt: Optional[torch.Tensor] = None
    qt: Optional[torch.Tensor] = None


def gta_fused_fwd(
    qB: torch.Tensor,
    kB: torch.Tensor,
    vB: torch.Tensor,
    t: FusedTables,
    heads: int,
    scale: float,
    residuals: bool = False,
):
    """Fused GTA attention forward over token-major operands.

    CPU tensors take `gta_fused_fwd_plain`; CUDA tensors launch the kernel
    instance of their dtype (fp32 or bf16) or raise. With `residuals`,
    returns (out, Residuals) for the backward. `gta_fused_fwd.launches`
    (fp32) and `gta_fused_fwd.launches_bf16` count launches of the C entry
    points: each one runs the row transforms of Q, K and V (each side that
    has one), the means of the key and value rows (the core's centres; bf16
    then writes the transformed rows centred), the tensor-core main kernel
    and the output transform (with v_transform), so the card sees up to six
    kernel launches per count (ten in bf16: with rotors alone on the
    output, the core keeps z in fp32 and a row launch rounds it for the
    residual). `launches_by_width` and `launches_bf16_by_width` count them
    by instance width.
    """
    if qB.device.type == "cpu":
        if residuals:
            out, z = gta_fused_fwd_plain(qB, kB, vB, t, heads, scale, store_z=True)
            return out, Residuals(z)
        return gta_fused_fwd_plain(qB, kB, vB, t, heads, scale)
    B, Tq, Tk, D, C0, C = _check_kernel_call("gta_fused_fwd", qB, kB, vB, t, heads)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in [qB, kB, vB] + _tables(t)):
        raise RuntimeError(
            "gta_fused_fwd's output carries no autograd graph: differentiate through "
            "fused_gta_attention_tokens (GTAFusedAttention)"
        )
    dev, bf16 = qB.device, qB.dtype == torch.bfloat16
    # from here on at the instance's width C (C0 the call's own)
    qB, kB, vB = (_cuda.pad_heads(x, heads, C) for x in (qB, kB, vB))
    t = _pad_tables(t, C0, C)
    q_transform = t.mq is not None or t.cq is not None
    kv_transform = t.mk is not None or t.ck is not None

    def rows(T, dtype, cond=True):  # heads-first [B, H, T, C] scratch
        return torch.empty((B, heads, T, C), dtype=dtype, device=dev) if cond else None

    qt = rows(Tq, qB.dtype, q_transform)
    kt = rows(Tk, qB.dtype, kv_transform)
    vt = rows(Tk, qB.dtype, kv_transform and t.v_transform)
    kt32 = rows(Tk, torch.float32, bf16 and kv_transform)  # bf16: transformed rows before centring
    # bf16, rotors alone on the output: z before its one rounding
    z32 = torch.empty(qB.shape, dtype=torch.float32, device=dev) if (
        bf16 and t.v_transform and t.cq is not None and t.mo is None) else None
    centres = torch.empty((2, B, heads, C), dtype=torch.float32, device=dev)
    out = torch.empty_like(qB)
    z = torch.empty_like(qB) if residuals and t.v_transform else None
    lse = torch.empty((B, heads, Tq), dtype=torch.float32, device=dev) if residuals else None
    fn, err_str = _bind_fwd(bf16, C)
    scratch = [qt, kt32, kt, vt, centres, z32] if bf16 else [qt, kt, vt, centres]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            _ptr(qB), _ptr(kB), _ptr(vB), *(_ptr(x) for x in _tables(t)), *(_ptr(x) for x in scratch),
            _ptr(out), _ptr(z), _ptr(lse), B, heads, Tq, Tk, C, t.nq, t.nk, _flags(t),
            float(scale), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"gta_fused_fwd launch failed: {err_str(err).decode()}")
    _cuda.count_launch(gta_fused_fwd, bf16, C)
    out = _cuda.unpad_heads(out, heads, C0)
    if residuals:
        return out, Residuals(out if z is None else _cuda.unpad_heads(z, heads, C0), lse, kt, vt, qt)
    return out


_cuda.launch_counters(gta_fused_fwd)


def _dm_splits(dev: torch.device, B: int, n: int, rows_per_view: int) -> int:
    """Row slices per (batch, view) in the dM reduction: enough blocks for
    four per SM, each slice at least one staging step of rows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(math.ceil(4 * sms / (B * n)), math.ceil(rows_per_view / _DM_ROWS)))


def gta_fused_bwd(
    qB: torch.Tensor,
    kB: torch.Tensor,
    vB: torch.Tensor,
    t: FusedTables,
    heads: int,
    scale: float,
    g: torch.Tensor,
    res: Residuals,
    keep: Optional[dict] = None,
) -> Tuple[torch.Tensor, ...]:
    """Fused GTA attention backward: (dq, dk, dv, dmq, dmk, dmo) as
    `gta_fused_bwd_plain` returns them.

    CPU tensors take `gta_fused_bwd_plain` (from g and res.z); CUDA tensors
    launch the kernel instance of their dtype (csrc/gta_fused_bwd.cu) with
    the forward kernel's residuals, or raise. `gta_fused_bwd.launches`
    (fp32) and `gta_fused_bwd.launches_bf16` count launches of the C entry
    points: each one runs the output chain, the core's centres (fp32), a
    query pass, a key pass, the query and key/value chains and a reduction
    pair per matrix cotangent, up to thirteen kernels (fourteen for the
    fp32 instance at head width 96, whose key pass is two launches).
    `keep`, a dict, receives the chains' fp32 inputs dz, dzq, dzk, dzv
    (None where absent), as `gta_fused_bwd_plain` does.
    """
    if qB.device.type == "cpu":
        return gta_fused_bwd_plain(qB, kB, vB, t, heads, scale, g, res.z, keep=keep)
    bf16 = qB.dtype == torch.bfloat16
    q_transform = t.mq is not None or t.cq is not None
    kv_transform = t.mk is not None or t.ck is not None
    if res.lse is None or (q_transform and res.qt is None) or (kv_transform and res.kt is None) or (
        kv_transform and t.v_transform and res.vt is None
    ):
        raise ValueError("gta_fused_bwd needs the forward kernel's residuals (lse, qt, kt, vt)")
    same = [g, res.z] + [x for x in (res.qt, res.kt, res.vt) if x is not None]
    B, Tq, Tk, D, C0, C = _check_kernel_call("gta_fused_bwd", qB, kB, vB, t, heads, same, [res.lse])
    if g.shape != qB.shape or res.z.shape != qB.shape or res.lse.shape != (B, heads, Tq):
        raise ValueError("gta_fused_bwd: g, z must be [B, Tq, H*C] and lse [B, H, Tq]")
    # from here on at the instance's width C (C0 the call's own), as the
    # forward's scratch residuals are
    qB, kB, vB, g, z = (_cuda.pad_heads(x, heads, C) for x in (qB, kB, vB, g, res.z))
    t, D = _pad_tables(t, C0, C), heads * C
    dev = qB.device

    def empty(shape, cond=True, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev) if cond else None

    has_mo = t.mo is not None and t.v_transform
    do_s = empty((B, Tq, D), dtype=qB.dtype)
    delta = empty((B, heads, Tq))
    dzq = empty((B, Tq, D), t.mq is not None)
    dz = empty((B, Tq, D), has_mo)
    dzk = empty((B, Tk, D), t.mk is not None)
    dzv = empty((B, Tk, D), t.mk is not None and t.v_transform)
    splits_q = _dm_splits(dev, B, t.nq, Tq // t.nq * heads)
    splits_k = _dm_splits(dev, B, t.nk, Tk // t.nk * heads)
    part = empty((B * max(t.nq * splits_q, t.nk * splits_k), C, C))
    # bf16: the core's fp32 gradients before the chains (before `part`);
    # fp32: the core's centres (after it)
    grads32 = [empty((B, Tq, D)), empty((B, Tk, D)), empty((B, Tk, D))] if bf16 else []
    centres = [] if bf16 else [empty((2, B, heads, C))]
    dq, dk, dv = torch.empty_like(qB), torch.empty_like(kB), torch.empty_like(vB)
    dmq, dmk = (None if M is None else torch.empty_like(M) for M in (t.mq, t.mk))
    dmo = torch.empty_like(t.mo) if has_mo else None
    fn, err_str = _bind_bwd(bf16, C)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            _ptr(qB), _ptr(kB), _ptr(vB), *(_ptr(x) for x in _tables(t)), _ptr(g), _ptr(z),
            _ptr(res.lse), _ptr(res.qt), _ptr(res.kt), _ptr(res.vt), _ptr(do_s), _ptr(delta),
            _ptr(dzq), _ptr(dz), _ptr(dzk), _ptr(dzv), *(_ptr(x) for x in grads32),
            _ptr(part), *(_ptr(x) for x in centres), _ptr(dq), _ptr(dk),
            _ptr(dv), _ptr(dmq), _ptr(dmk), _ptr(dmo), B, heads, Tq, Tk, C, t.nq, t.nk, splits_q, splits_k,
            _flags(t), float(scale), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"gta_fused_bwd launch failed: {err_str(err).decode()}")
    _cuda.count_launch(gta_fused_bwd, bf16, C)
    rows = lambda x: None if x is None else _cuda.unpad_heads(x, heads, C0)  # noqa: E731
    mat = lambda x: None if x is None else x[..., :C0, :C0].contiguous() if C0 != C else x  # noqa: E731
    if keep is not None:
        keep.update(dz=rows(dz), dzq=rows(dzq), dzk=rows(dzk), dzv=rows(dzv))
    return rows(dq), rows(dk), rows(dv), mat(dmq), mat(dmk), mat(dmo)


_cuda.launch_counters(gta_fused_bwd)


@dataclasses.dataclass(frozen=True)
class _Static:
    heads: int
    scale: float
    nq: int
    nk: int
    v_transform: bool


class GTAFusedAttention(torch.autograd.Function):
    """The fused forward with the fused backward as its gradient
    (`_core` with `_core_fwd`/`_core_bwd`): cotangents for q, k, v and the
    matrix tables; None for the rotor tables, which are functions of data
    coordinates only."""

    @staticmethod
    def forward(ctx, qB, kB, vB, mq, mk, mo, cq, sq, ck, sk, st: _Static):
        t = FusedTables(mq, mk, mo, cq, sq, ck, sk, st.nq, st.nk, st.v_transform)
        out, res = gta_fused_fwd(qB, kB, vB, t, st.heads, st.scale, residuals=True)
        ctx.st = st
        ctx.save_for_backward(qB, kB, vB, mq, mk, mo, cq, sq, ck, sk, res.z, res.lse, res.kt, res.vt, res.qt)
        return out

    @staticmethod
    def backward(ctx, g):
        qB, kB, vB, mq, mk, mo, cq, sq, ck, sk, z, lse, kt, vt, qt = ctx.saved_tensors
        st = ctx.st
        t = FusedTables(mq, mk, mo, cq, sq, ck, sk, st.nq, st.nk, st.v_transform)
        dq, dk, dv, dmq, dmk, dmo = gta_fused_bwd(
            qB, kB, vB, t, st.heads, st.scale, g.contiguous(), Residuals(z, lse, kt, vt, qt)
        )
        return dq, dk, dv, dmq, dmk, dmo, None, None, None, None, None


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
    """GTA attention over token-major [B, T, H*C] operands (the layer's
    entry). Differentiable through `GTAFusedAttention` when grad is enabled
    and an operand requires it."""
    check_supported(reps, args, qB.shape[1], kB.shape[1])
    t = fused_tables(reps, args, trans_coeff)
    qB, kB, vB = qB.contiguous(), kB.contiguous(), vB.contiguous()
    if torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in [qB, kB, vB] + _tables(t)
    ):
        st = _Static(heads, float(scale), t.nq, t.nk, t.v_transform)
        return GTAFusedAttention.apply(qB, kB, vB, *_tables(t), st)
    return gta_fused_fwd(qB, kB, vB, t, heads, scale)
