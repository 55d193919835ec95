"""Plain softmax attention through hand-written kernels, forward and backward.

Port of gta_tpu/ops/flash_core.py (`_fwd_kernel`, `_bwd_kernel` and the
custom VJP `flash_core`): softmax(q k^T * scale) v without materialising
the attention matrix. Operands arrive token-major [B, T, H*C], as the
layer's projections produce them, so no call transposes to heads-first.

Dispatch, with no fallbacks: a CPU tensor takes the plain PyTorch versions
(`flash_core_fwd_plain`, `flash_core_bwd_plain`); a CUDA tensor launches the
hand-written kernels (csrc/flash_core_fwd.cu, csrc/flash_core_bwd.cu, thin
entries to the attention cores the fused GTA kernels share: fp32
csrc/attn_core.cuh, bf16 csrc/attn_sm90.cuh) or raises. The kernels have
instances at head widths 32, 64, 96 and 128; any other multiple of 8 in
[32, 128] runs in the next one up, its operands zero-padded per head
(zero columns add nothing to a score and give zero output columns) and the
results cut back to C (ops/_cuda.py `kernel_head_dim`); other widths
raise. With grad enabled and an operand that requires it, the call goes
through `FlashCore`, whose backward is the backward kernel. Unlike the
Pallas kernel (whole K/V of a head in VMEM, Tk <= 2048), the forward tiles
K with an online softmax, so every key length takes the same kernel.

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
  * fp32 operands with `mxu_dtype=torch.bfloat16` (`flash_core`; GTA's
    sliced path under bf16, ops/gta_pallas.py): what the TPU kernel does
    with the fp32 rows of gta_tpu/ops/gta_pallas.py:72 when it runs on a
    TPU (`mxu_dtype` bf16 there): the bf16 instance on the rows rounded to
    bf16 (and the cotangent, in the backward), writing the output and dq,
    dk, dv in fp32 (`out_dtype`) from its fp32 accumulators.
The plain versions compute in fp32 from operands of either dtype (fp64 for
fp64 ones), the Pallas kernel's interpret mode; `mxu_dtype=torch.bfloat16`
rounds every product's operands to bf16 as the TPU kernel does. A CPU
tensor takes them as interpret mode runs (`flash_core` does not pass its
`mxu_dtype` on to them).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gta_tpu_torch.ops import _cuda


def work_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: fp64 for fp64 operands, else fp32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _operand(x: torch.Tensor, work: torch.dtype, mxu_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x as a product operand of the plain versions: rounded to bf16 when
    `mxu_dtype` is bf16 (the TPU kernel's `_dot`), in `work` precision."""
    return (x.to(torch.bfloat16) if mxu_dtype == torch.bfloat16 else x).to(work)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """Token-major [B, T, H*C] -> heads-first [B, H, T, C] (a view)."""
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """Heads-first [B, H, T, C] -> token-major [B, T, H*C]."""
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
    out_dtype: Optional[torch.dtype] = None,
):
    """Plain PyTorch version of the forward kernel (with bf16 operands as
    `_fwd_kernel` computes it: o = (e v) / rowsum(e), e = exp(s - max)). q [B, Tq, H*C],
    k/v [B, Tk, H*C] -> out [B, Tq, H*C] in `out_dtype` (q's dtype by
    default); with `lse`,
    (out, lse) where lse [B, H, Tq] is each row's log-sum-exp of the scaled
    scores. `mxu_dtype=torch.bfloat16` rounds every product's operands to
    bf16 (see the module docstring)."""
    work = work_dtype(q)
    s = _dot("bhqc,bhkc->bhqk", split_heads(q, heads), split_heads(k, heads), work, mxu_dtype) * scale
    if mxu_dtype == torch.bfloat16:  # the TPU kernel rounds e = exp(s - max) for the product, then divides
        e = torch.exp(s - s.amax(-1, keepdim=True))
        o = _dot("bhqk,bhkc->bhqc", e, split_heads(v, heads), work, mxu_dtype) / e.sum(-1, keepdim=True)
    else:
        o = torch.einsum("bhqk,bhkc->bhqc", torch.softmax(s, dim=-1), split_heads(v, heads).to(work))
    out = merge_heads(o).to(out_dtype or q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if lse else out


def flash_core_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float,
    g: torch.Tensor,
    mxu_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, `_bwd_kernel`'s
    formulas: p recomputed from q and k, ds = p (dp - rowsum(p dp)) scale,
    dq = ds k, dk = ds^T q, dv = p^T g. g is the cotangent of the forward's
    output; returns token-major (dq, dk, dv) in `out_dtype` (their inputs'
    dtype by default). `mxu_dtype` as in `flash_core_fwd_plain`."""
    work = work_dtype(q)
    qh, kh, vh, gh = (split_heads(x, heads) for x in (q, k, v, g))
    p = torch.softmax(_dot("bhqc,bhkc->bhqk", qh, kh, work, mxu_dtype) * scale, dim=-1)
    dp = _dot("bhqc,bhkc->bhqk", gh, vh, work, mxu_dtype)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = _dot("bhqk,bhkc->bhqc", ds, kh, work, mxu_dtype)
    dk = _dot("bhqk,bhqc->bhkc", ds, qh, work, mxu_dtype)
    dv = _dot("bhqk,bhqc->bhkc", p, gh, work, mxu_dtype)
    return tuple(merge_heads(d).to(out_dtype or x.dtype) for d, x in ((dq, q), (dk, k), (dv, v)))


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _check_kernel_call(name, q, k, v, heads: int, same=(), f32=()):
    """Validate a kernel launch's operands: q, k, v and `same` contiguous in
    one dtype that an instance covers, `f32` (log-sum-exp) contiguous fp32,
    all on q's CUDA device. Returns (B, Tq, Tk, C, width): width the head
    width of the instance that runs C."""
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash_core kernel for device {q.device}")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    C = D // heads
    width = _cuda.kernel_head_dim(name, C)
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
    return B, Tq, Tk, C, width


def _bind(name: str, bf16: bool, width: int, n_ptrs: int, n_ints: int):
    """(entry, error string) of kernel `name`'s library at head width
    `width`: its fp32 or bf16 entry."""
    lib = _cuda.load(name, width)
    fn = getattr(lib, f"{name}_bf16" if bf16 else name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _out_dtype(q: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype a kernel call writes: the operands' by default; fp32 also
    for bf16 operands (the bf16 instance's fp32 output)."""
    out = out_dtype or q.dtype
    if out != q.dtype and not (q.dtype == torch.bfloat16 and out == torch.float32):
        raise ValueError(f"flash_core: no instance writes {out} from {q.dtype} operands")
    return out


def flash_core_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float,
    residuals: bool = False,
    out_dtype: Optional[torch.dtype] = None,
):
    """softmax(q k^T * scale) v over token-major operands.

    CPU tensors take `flash_core_fwd_plain`; CUDA tensors launch the kernel
    instance of their dtype (fp32 or bf16) or raise. The output is in
    `out_dtype`: the operands' dtype by default, or fp32 from bf16 operands.
    With `residuals`, returns (out, lse), lse [B, H, Tq] being each row's
    log-sum-exp for the backward. `flash_core_fwd.launches` (fp32) and
    `flash_core_fwd.launches_bf16` count launches of the C entry points
    (`launches_by_width`, `launches_bf16_by_width` by instance width).
    """
    out_dtype = _out_dtype(q, out_dtype)
    if q.device.type == "cpu":
        return flash_core_fwd_plain(q, k, v, heads, scale, lse=residuals, out_dtype=out_dtype)
    B, Tq, Tk, C, width = _check_kernel_call("flash_core_fwd", q, k, v, heads)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_core_fwd's output carries no autograd graph: differentiate through "
            "flash_core (FlashCore)"
        )
    bf16 = q.dtype == torch.bfloat16
    q, k, v = (_cuda.pad_heads(x, heads, width) for x in (q, k, v))
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((B, heads, Tq), dtype=torch.float32, device=q.device) if residuals else None
    # fp32: the core's centres (the value rows' mean, c_v) as scratch
    centres = [] if bf16 else [torch.empty((2, B, heads, width), dtype=torch.float32, device=q.device)]
    ints = (B, heads, Tq, Tk, width) + ((int(out_dtype == torch.float32),) if bf16 else ())
    fn, err_str = _bind("flash_core_fwd", bf16, width, 5 + len(centres), len(ints))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), None if lse is None else _ptr(lse), *(_ptr(x) for x in centres),
            *ints, float(scale), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"flash_core_fwd launch failed: {err_str(err).decode()}")
    _cuda.count_launch(flash_core_fwd, bf16, width)
    out = _cuda.unpad_heads(out, heads, C)
    return (out, lse) if residuals else out


_cuda.launch_counters(flash_core_fwd)


def flash_core_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: Optional[torch.Tensor],
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of `flash_core_fwd`: token-major (dq, dk, dv) in
    `out_dtype` (as `flash_core_fwd`'s) from the cotangent g of its output,
    g in the operands' dtype.

    CPU tensors take `flash_core_bwd_plain` (from q, k, v and g); CUDA
    tensors launch the kernel instance of their dtype (csrc/flash_core_bwd.cu)
    with the forward's log-sum-exp (and, fp32, its output), or raise.
    `flash_core_bwd.launches` (fp32) and `flash_core_bwd.launches_bf16`
    count launches of the C entry points, each a query pass and a key pass
    (fp32: after the centres' launches, the query pass computes delta =
    rowsum(g * (out - c_v)); bf16: it takes
    delta from its own products, and both passes write the gradients
    straight from their fp32 accumulators).
    """
    out_dtype = _out_dtype(q, out_dtype)
    if q.device.type == "cpu":
        return flash_core_bwd_plain(q, k, v, heads, scale, g, out_dtype=out_dtype)
    if lse is None:
        raise ValueError("flash_core_bwd needs the forward kernel's log-sum-exp")
    B, Tq, Tk, C, width = _check_kernel_call("flash_core_bwd", q, k, v, heads, (g,), (lse,))
    if g.shape != q.shape or out.shape != q.shape or lse.shape != (B, heads, Tq):
        raise ValueError("flash_core_bwd: g, out must be [B, Tq, H*C] and lse [B, H, Tq]")
    bf16 = q.dtype == torch.bfloat16
    dev = q.device
    q, k, v, g = (_cuda.pad_heads(x, heads, width) for x in (q, k, v, g))
    delta = torch.empty((B, heads, Tq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty(x.shape, dtype=out_dtype, device=dev) for x in (q, k, v))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf16:
        args = [q, k, v, g, lse, delta, dq, dk, dv]
        ints = (B, heads, Tq, Tk, width, int(out_dtype == torch.float32))
    else:  # with the forward's output, and the core's centres (the means of the key and value rows) as scratch
        if out.dtype != q.dtype or out.device != dev or not out.is_contiguous():
            raise ValueError("flash_core_bwd: out must be the fp32 forward's contiguous output")
        out = _cuda.pad_heads(out, heads, width)
        centres = torch.empty((2, B, heads, width), dtype=torch.float32, device=dev)
        args = [q, k, v, g, out, lse, delta, centres, dq, dk, dv]
        ints = (B, heads, Tq, Tk, width)
    fn, err_str = _bind("flash_core_bwd", bf16, width, len(args), len(ints))
    with torch.cuda.device(dev):
        err = fn(*(_ptr(x) for x in args), *ints, float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_core_bwd launch failed: {err_str(err).decode()}")
    _cuda.count_launch(flash_core_bwd, bf16, width)
    return tuple(_cuda.unpad_heads(d, heads, C) for d in (dq, dk, dv))


_cuda.launch_counters(flash_core_bwd)


class FlashCore(torch.autograd.Function):
    """The forward with its training residual (each row's log-sum-exp) and
    the backward as its gradient (the JAX package's `flash_core` custom
    VJP). Operands and cotangents are contiguous token-major [B, T, H*C].
    With `to_bf16`, fp32 operands go to the bf16 instance rounded to bf16
    (the cotangent too), which writes the output and the gradients in fp32
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float, to_bf16: bool):
        out_dtype = q.dtype
        if to_bf16:
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        out, lse = flash_core_fwd(q, k, v, heads, scale, residuals=True, out_dtype=out_dtype)
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_core_bwd(q, k, v, ctx.heads, ctx.scale, g.to(q.dtype).contiguous(), out, lse,
                                    out_dtype=out.dtype)
        return dq, dk, dv, None, None, None


def flash_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float,
    mxu_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale) v over token-major [B, T, H*C] operands (the
    layer's entry; strided views, such as the chunks of a fused q/k/v
    projection, are made contiguous), in the operands' dtype. Differentiable
    through `FlashCore` when grad is enabled and an operand requires it.
    `mxu_dtype=torch.bfloat16` with fp32 operands: bf16 products, fp32
    output and gradients, on a CUDA tensor (on a CPU tensor the plain
    version in fp32, as interpret mode computes it)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    to_bf16 = q.device.type != "cpu" and mxu_dtype == torch.bfloat16 and q.dtype == torch.float32
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashCore.apply(q, k, v, heads, float(scale), to_bf16)
    if to_bf16:
        return flash_core_fwd(*(x.to(torch.bfloat16) for x in (q, k, v)), heads, scale, out_dtype=q.dtype)
    return flash_core_fwd(q, k, v, heads, scale)
