"""Plain softmax attention through hand-written kernels, forward and backward.

Port of gta_tpu/ops/flash_core.py (`_fwd_kernel`, `_bwd_kernel` and the
custom VJP `flash_core`): softmax(q k^T * scale) v without materialising
the attention matrix. Operands arrive token-major [B, T, H*C], as the
layer's projections produce them, so no call transposes to heads-first.

Dispatch, with no fallbacks: a CPU tensor takes the plain PyTorch versions
(`flash_core_fwd_plain`, `flash_core_bwd_plain`); a CUDA tensor launches the
hand-written kernels (csrc/flash_core_fwd.cu, csrc/flash_core_bwd.cu, thin
entries to the attention cores the fused GTA kernels share: fp32
csrc/attn_core.cuh, bf16 csrc/attn_sm90.cuh) or raises. With grad enabled and an operand that
requires it, the call goes through `FlashCore`, whose backward is the
backward kernel. Unlike the Pallas kernel (whole K/V of a head in VMEM,
Tk <= 2048), the forward tiles K with an online softmax, so every key
length takes the same kernel.

Precision, by the operands' dtype (the JAX package's rules: the output
and dq, dk, dv in the inputs' dtype, gta_tpu/ops/flash_core.py:83,
:124-126, :174):
  * fp32: fp32 accuracy throughout: every product on the tensor cores as
    3xTF32 (each fp32 operand split into two TF32 parts, three products
    summed in fp32; csrc/tf32x3.cuh), the softmax in fp32.
  * bf16: the TPU kernel's rounding: the products take bf16 operands (q,
    k, v, g, P, dS) with fp32 accumulation (wgmma fed by TMA); the
    softmax, lse and delta stay fp32, and each output is rounded to bf16
    once, from its fp32 accumulator.
The plain versions compute in fp32 from operands of either dtype (fp64 for
fp64 ones), the Pallas kernel's interpret mode; `mxu_dtype=torch.bfloat16`
rounds every product's operands to bf16 as the TPU kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gta_tpu_torch.ops import _cuda

KERNEL_HEAD_DIM = 64  # the head width the CUDA kernels are compiled for


def work_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: fp64 for fp64 operands, else fp32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _operand(x: torch.Tensor, work: torch.dtype, mxu_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x as a product operand of the plain versions: rounded to bf16 when
    `mxu_dtype` is bf16 (the TPU kernel's `_dot`), in `work` precision."""
    return (x.to(torch.bfloat16) if mxu_dtype == torch.bfloat16 else x).to(work)


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    B, H, T, C = x.shape
    return x.transpose(1, 2).reshape(B, T, H * C)


def _dot(eq, a, b, work, mxu_dtype):
    return torch.einsum(eq, _operand(a, work, mxu_dtype), _operand(b, work, mxu_dtype))


def flash_core_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float,
    lse: bool = False,
    mxu_dtype: Optional[torch.dtype] = None,
):
    """Plain PyTorch version of the forward kernel (with bf16 operands as
    `_fwd_kernel` computes it: o = (e v) / rowsum(e), e = exp(s - max)). q [B, Tq, H*C],
    k/v [B, Tk, H*C] -> out [B, Tq, H*C] in q's dtype; with `lse`,
    (out, lse) where lse [B, H, Tq] is each row's log-sum-exp of the scaled
    scores. `mxu_dtype=torch.bfloat16` rounds every product's operands to
    bf16 (see the module docstring)."""
    work = work_dtype(q)
    s = _dot("bhqc,bhkc->bhqk", _heads_first(q, heads), _heads_first(k, heads), work, mxu_dtype) * scale
    if mxu_dtype == torch.bfloat16:  # the TPU kernel rounds e = exp(s - max) for the product, then divides
        e = torch.exp(s - s.amax(-1, keepdim=True))
        o = _dot("bhqk,bhkc->bhqc", e, _heads_first(v, heads), work, mxu_dtype) / e.sum(-1, keepdim=True)
    else:
        o = torch.einsum("bhqk,bhkc->bhqc", torch.softmax(s, dim=-1), _heads_first(v, heads).to(work))
    out = _tokens(o).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if lse else out


def flash_core_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float,
    g: torch.Tensor,
    mxu_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, `_bwd_kernel`'s
    formulas: p recomputed from q and k, ds = p (dp - rowsum(p dp)) scale,
    dq = ds k, dk = ds^T q, dv = p^T g. g is the cotangent of the forward's
    output; returns token-major (dq, dk, dv) in their inputs' dtype.
    `mxu_dtype` as in `flash_core_fwd_plain`."""
    work = work_dtype(q)
    qh, kh, vh, gh = (_heads_first(x, heads) for x in (q, k, v, g))
    p = torch.softmax(_dot("bhqc,bhkc->bhqk", qh, kh, work, mxu_dtype) * scale, dim=-1)
    dp = _dot("bhqc,bhkc->bhqk", gh, vh, work, mxu_dtype)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = _dot("bhqk,bhkc->bhqc", ds, kh, work, mxu_dtype)
    dk = _dot("bhqk,bhqc->bhkc", ds, qh, work, mxu_dtype)
    dv = _dot("bhqk,bhqc->bhkc", p, gh, work, mxu_dtype)
    return _tokens(dq).to(q.dtype), _tokens(dk).to(k.dtype), _tokens(dv).to(v.dtype)


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _check_kernel_call(name, q, k, v, heads: int, same=(), f32=()):
    """Validate a kernel launch's operands: q, k, v and `same` contiguous in
    one dtype that an instance covers, `f32` (log-sum-exp) contiguous fp32,
    all on q's CUDA device. Returns (B, Tq, Tk, C)."""
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash_core kernel for device {q.device}")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    C = D // heads
    if C != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"{name}: the CUDA kernel is built for head dim {KERNEL_HEAD_DIM}, got {C} "
            "(ROADMAP queue 1 item 3d: other head widths)"
        )
    bad = ValueError(f"{name} operands must be contiguous fp32 (or bf16 beside an fp32 lse) on one CUDA device")
    for x in (q, k, v, *same):
        if x.device != q.device or x.dtype != q.dtype or not x.is_contiguous():
            raise bad
    _cuda.check_kernel_dtype(name, q.dtype)
    for x in f32:
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise bad
    if k.shape != (B, Tk, D) or v.shape != (B, Tk, D) or D != heads * C:
        raise ValueError(f"bad operand shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    return B, Tq, Tk, C


def _bind(name: str, bf16: bool, n_ptrs: int, n_ints: int):
    """(entry, error string) of library `name`: its fp32 or bf16 entry."""
    lib = _cuda.load(name)
    fn = getattr(lib, f"{name}_bf16" if bf16 else name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def flash_core_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float, residuals: bool = False
):
    """softmax(q k^T * scale) v over token-major operands.

    CPU tensors take `flash_core_fwd_plain`; CUDA tensors launch the kernel
    instance of their dtype (fp32 or bf16) or raise. With `residuals`,
    returns (out, lse), lse [B, H, Tq] being each row's log-sum-exp for the
    backward. `flash_core_fwd.launches` (fp32) and
    `flash_core_fwd.launches_bf16` count launches of the C entry points.
    """
    if q.device.type == "cpu":
        return flash_core_fwd_plain(q, k, v, heads, scale, lse=residuals)
    B, Tq, Tk, C = _check_kernel_call("flash_core_fwd", q, k, v, heads)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_core_fwd's output carries no autograd graph: differentiate through "
            "flash_core (FlashCore)"
        )
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((B, heads, Tq), dtype=torch.float32, device=q.device) if residuals else None
    fn, err_str = _bind("flash_core_fwd", bf16, 5, 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), None if lse is None else _ptr(lse),
            B, heads, Tq, Tk, C, float(scale), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"flash_core_fwd launch failed: {err_str(err).decode()}")
    if bf16:
        flash_core_fwd.launches_bf16 += 1
    else:
        flash_core_fwd.launches += 1
    return (out, lse) if residuals else out


flash_core_fwd.launches = 0
flash_core_fwd.launches_bf16 = 0


def flash_core_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of `flash_core_fwd`: token-major (dq, dk, dv) from the
    cotangent g of its output.

    CPU tensors take `flash_core_bwd_plain` (from q, k, v and g); CUDA
    tensors launch the kernel instance of their dtype (csrc/flash_core_bwd.cu)
    with the forward's log-sum-exp (and, fp32, its output), or raise.
    `flash_core_bwd.launches` (fp32) and `flash_core_bwd.launches_bf16`
    count launches of the C entry points, each a query pass and a key pass
    (fp32: the query pass computes delta = rowsum(g * out); bf16: it takes
    delta from its own products, and both passes write the bf16 gradients
    straight from their fp32 accumulators).
    """
    if q.device.type == "cpu":
        return flash_core_bwd_plain(q, k, v, heads, scale, g)
    if lse is None:
        raise ValueError("flash_core_bwd needs the forward kernel's log-sum-exp")
    B, Tq, Tk, C = _check_kernel_call("flash_core_bwd", q, k, v, heads, (g, out), (lse,))
    if g.shape != q.shape or out.shape != q.shape or lse.shape != (B, heads, Tq):
        raise ValueError("flash_core_bwd: g, out must be [B, Tq, H*C] and lse [B, H, Tq]")
    bf16 = q.dtype == torch.bfloat16
    dev = q.device
    delta = torch.empty((B, heads, Tq), dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [q, k, v, g, lse, delta, dq, dk, dv] if bf16 else [q, k, v, g, out, lse, delta, dq, dk, dv]
    fn, err_str = _bind("flash_core_bwd", bf16, len(args), 5)
    with torch.cuda.device(dev):
        err = fn(*(_ptr(x) for x in args), B, heads, Tq, Tk, C, float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_core_bwd launch failed: {err_str(err).decode()}")
    if bf16:
        flash_core_bwd.launches_bf16 += 1
    else:
        flash_core_bwd.launches += 1
    return dq, dk, dv


flash_core_bwd.launches = 0
flash_core_bwd.launches_bf16 = 0


class FlashCore(torch.autograd.Function):
    """The forward with its training residual (each row's log-sum-exp) and
    the backward as its gradient (the JAX package's `flash_core` custom
    VJP). Operands and cotangents are contiguous token-major [B, T, H*C]."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        out, lse = flash_core_fwd(q, k, v, heads, scale, residuals=True)
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_core_bwd(q, k, v, ctx.heads, ctx.scale, g.contiguous(), out, lse)
        return dq, dk, dv, None, None


def flash_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over token-major [B, T, H*C] operands (the
    layer's entry; strided views, such as the chunks of a fused q/k/v
    projection, are made contiguous). Differentiable through `FlashCore`
    when grad is enabled and an operand requires it."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashCore.apply(q, k, v, heads, float(scale))
    return flash_core_fwd(q, k, v, heads, scale)
