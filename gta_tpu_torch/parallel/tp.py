"""Tensor parallel: attention heads and FFN hidden units sharded over the
model axis (the JAX package's parallel/tp.py).

JAX annotates the kernels' [in, out] layouts (`_spec_for`, tp.py:32) and
lets GSPMD partition the step; torch has no such help, so the split is
explicit here, in torch's [out, in] orientation. Model rank m of N keeps,
in every layer that splits:
  - the rows of its heads in each section of the input projections:
    `to_qkv` has three sections (q, k, v), `to_kv` two, `to_q` (and
    repast's `to_k` and `to_v`) one; a plain contiguous split of to_qkv's
    3 H C rows would give rank 0 every q head and no v head;
  - rpe's per-head rep vectors (`q_bias`, `k_bias`, `v_bias`, [H, d]);
  - the matching columns of `to_out.0` (rpe's heads are C + d columns
    each, head-major, as merge_heads lays them out);
  - a contiguous block of `net.0`'s rows (and bias) in each FeedForward
    and the matching columns of `net.3`.
Everything else stays whole on every rank. The rank's heads are heads
[m H/N, (m + 1) H/N), and attention runs on them through the same route as
in one process (the fused GTA kernels, flash_core, or torch eager for the
methods JAX computes with XLA): GTA's rep tables, gbt's Plücker distances
and the other geometry are head-independent and stay whole.

An attention layer whose heads N does not divide, or a FeedForward whose
hidden width it does not divide, runs whole on every model rank, as JAX's
fused kernel falls back to the whole layer there (tp.py:97-100) and GSPMD
computes the rest replicated: its parameters stay whole, every rank takes
their whole gradient itself, and nothing of it is summed over the axis
(`param_specs` leaves them out, so ZeRO-1, the gradient norm and the
checkpoints treat them as unsplit). Splitting inside a head is not done.
`describe` reports which layers split.

Megatron's pair of autograd functions carries a split layer: `copy_in`
(the identity forward, a sum over the model ranks backward) where a whole
activation enters the sharded projections, and `row_parallel` (the
partial product, a sum forward, the identity backward) after `to_out` and
`net.3`, whose biases are added once, after the sum. A head-independent
parameter used inside the rank's heads (GTA's trans_coeff, the adjustable
softmax's tau, gbt's geo_weights, elementwise_mul's rep_to_vec outputs)
enters through `copy_in` too, so its gradient is whole on every rank. A
layer that returns its attention map gathers the heads' maps whole over
the axis. Under bf16 every sharded product runs in fp32 on the
bf16-rounded operands (exact products, fp32 sums) and is rounded to bf16
once after the sum over ranks, forward and backward: the one-process bf16
GEMM rounds its fp32 accumulator once, and summing two bf16-rounded
partials would add a rounding it does not have.

Dropout on a sharded hidden activation draws the whole activation's mask
and keeps the rank's block (models/layers.Dropout.shards), so every rank's
generator stays where the one-process step's is, and the masks are that
step's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gta_tpu_torch.parallel import dist as pdist

# parameter name within its layer -> sections along dim 0 (the rows)
ROW_SPLITS = {"to_qkv.weight": 3, "to_qkv.bias": 3, "to_kv.weight": 2, "to_kv.bias": 2, "to_q.weight": 1,
              "to_q.bias": 1, "to_k.weight": 1, "to_k.bias": 1, "to_v.weight": 1, "to_v.bias": 1, "q_bias": 1,
              "k_bias": 1, "v_bias": 1, "net.0.weight": 1, "net.0.bias": 1}
COL_SPLITS = ("to_out.0.weight", "net.3.weight")

Spec = Tuple[int, int]  # (dim, sections)


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """{parameter name: (dim, sections)} of every parameter the model axis
    splits: those of the attention layers and FeedForwards that split
    (their `tp` set by `shard_model`)."""
    from gta_tpu_torch.models.layers import Attention, FeedForward

    specs = {}
    for prefix, module in model.named_modules():
        if isinstance(module, (Attention, FeedForward)) and module.tp is not None:
            for name, _ in module.named_parameters():
                if name in ROW_SPLITS:
                    specs[f"{prefix}.{name}"] = (0, ROW_SPLITS[name])
                elif name in COL_SPLITS:
                    specs[f"{prefix}.{name}"] = (1, 1)
    return specs


def describe(model: nn.Module, n_model: int) -> str:
    """Which attention layers and FeedForwards `n_model` model ranks split
    and which run whole, by module: "encoder: attention 5 split (6 heads, 3
    a rank), FeedForward 5 split (768 units, 384 a rank); ..."."""
    from gta_tpu_torch.models.layers import Attention, FeedForward

    parts = []
    for top, mod in model.named_children():
        groups: Dict[Tuple[str, bool, int], int] = {}
        for m in mod.modules():
            if isinstance(m, (Attention, FeedForward)):
                kind = "attention" if isinstance(m, Attention) else "FeedForward"
                width = m.heads if kind == "attention" else m.net[0].out_features
                if m.tp is not None:
                    width *= n_model
                key = (kind, m.tp is not None, width)
                groups[key] = groups.get(key, 0) + 1
        if groups:
            unit = {"attention": "heads", "FeedForward": "units"}
            parts.append(f"{top}: " + ", ".join(
                f"{kind} {n} " + (f"split ({w} {unit[kind]}, {w // n_model} a rank)" if split else
                                   f"whole ({w} {unit[kind]}: {n_model} does not divide them)")
                for (kind, split, w), n in groups.items()))
    return f"tensor parallel over {n_model} model ranks: " + "; ".join(parts)


def shard_tensor(full: torch.Tensor, spec: Spec, index: int, size: int) -> torch.Tensor:
    """Block `index` of `size` of each of `full`'s sections along the
    spec's dim, the blocks concatenated (a copy)."""
    dim, sections = spec
    return torch.cat([sec.chunk(size, dim)[index] for sec in full.chunk(sections, dim)], dim).clone()


def unshard_tensor(blocks: List[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The inverse of `shard_tensor` over every rank's block, in rank
    order."""
    dim, sections = spec
    parts = [b.chunk(sections, dim) for b in blocks]
    return torch.cat([parts[r][i] for i in range(sections) for r in range(len(blocks))], dim)


def gather_tensor(local: torch.Tensor, spec: Spec, axis: pdist.Axis) -> torch.Tensor:
    """The whole tensor from every model rank's block (collective)."""
    return unshard_tensor(pdist.all_gather(local.detach(), axis), spec)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        pdist.all_reduce_(g, ctx.axis)
        return g, None


class _SumOut(torch.autograd.Function):
    """A sum over the axis forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        x = x.contiguous().clone()
        pdist.all_reduce_(x, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: Optional[torch.Tensor], axis: pdist.Axis) -> Optional[torch.Tensor]:
    """`x`, whose gradient is summed over `axis` (Megatron's f)."""
    return x if x is None or axis.size == 1 else _CopyIn.apply(x, axis)


def sum_out(x: torch.Tensor, axis: pdist.Axis) -> torch.Tensor:
    """`x` summed over `axis`, its gradient passed through (Megatron's g)."""
    return x if axis.size == 1 else _SumOut.apply(x, axis)


class _RoundedProduct(torch.autograd.Function):
    """F.linear(x, weight) on both operands rounded to `dtype`, computed in
    fp32 (exact bf16 products, fp32 sums) and returned in fp32; it saves
    the rounded operands, as the one-process bf16 product does. Backward:
    the input's gradient in fp32, summed over `axis` where one is given
    (Megatron's f, `copy_in`) before autograd rounds it to x's dtype once;
    the weight's rounded to `dtype`, as the one-process product's is."""

    @staticmethod
    def forward(ctx, x, weight, dtype, axis):
        xr, wr = x.to(dtype), weight.to(dtype)
        ctx.save_for_backward(xr, wr)
        ctx.dtype, ctx.axis = dtype, axis
        return F.linear(xr.float(), wr.float())

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g.matmul(wr.float())
            if ctx.axis is not None:
                pdist.all_reduce_(gx, ctx.axis)
        if ctx.needs_input_grad[1]:
            gw = g.reshape(-1, g.shape[-1]).t().matmul(xr.float().reshape(-1, xr.shape[-1]))
            gw = gw.to(ctx.dtype).float()
        return gx, gw, None, None


def column_parallel(linear: nn.Linear, x: torch.Tensor, axis: pdist.Axis, dtype: torch.dtype) -> torch.Tensor:
    """The rank's output block of `linear` (its rows) on the whole input
    `x`, whose gradient sums over the axis (`copy_in`); under bf16 the
    product is fp32 and rounded once, and so is the summed input
    gradient."""
    if dtype == torch.float32:
        return F.linear(copy_in(x, axis), linear.weight, linear.bias)
    y = _RoundedProduct.apply(x, linear.weight, dtype, axis).to(dtype)
    return y if linear.bias is None else y + linear.bias.to(dtype)


def row_parallel(linear: nn.Linear, x: torch.Tensor, axis: pdist.Axis, dtype: torch.dtype) -> torch.Tensor:
    """`linear` on the rank's input block `x` (its columns): the partial
    product in fp32 (on bf16-rounded operands under bf16), summed over the
    axis, rounded to the compute dtype once, then the bias added once."""
    if dtype == torch.float32:
        y = sum_out(F.linear(x, linear.weight), axis)
    else:
        y = sum_out(_RoundedProduct.apply(x, linear.weight, dtype, None), axis).to(dtype)
    return y if linear.bias is None else y + linear.bias.to(dtype)


@torch.no_grad()
def shard_model(model: nn.Module, axis: pdist.Axis) -> Dict[str, Spec]:
    """Keep this model rank's block of every split parameter of `model`
    (which holds the whole, identical weights on every rank) and route the
    attention layers whose heads, and the FeedForwards whose hidden units,
    the model axis divides through it; the others stay whole. Returns
    `param_specs(model)`."""
    from gta_tpu_torch.models.layers import Attention, FeedForward

    for module in model.modules():
        if isinstance(module, Attention) and module.heads % axis.size == 0:
            module.tp = axis
            module.heads //= axis.size
        elif isinstance(module, FeedForward) and module.net[0].out_features % axis.size == 0:
            module.tp = axis
            hidden_dropout = module.net[2]  # on the rank's block of hidden units
            hidden_dropout.shards = hidden_dropout.shards + ((-1, axis.index, axis.size),)
    specs = param_specs(model)
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        p = params[name]
        p.data = shard_tensor(p.data, spec, axis.index, axis.size)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.out_features, module.in_features = module.weight.shape
    return specs


def sharded_norm_sq(named_grads: List[Tuple[str, torch.Tensor]], specs: Dict[str, Spec],
                    axis: pdist.Axis) -> torch.Tensor:
    """The squared L2 norm of the whole gradient from the ranks' blocks:
    the split tensors' squares summed over the axis, the whole ones once."""
    zero = torch.zeros((), device=named_grads[0][1].device)
    split = sum((torch.sum(g.float() ** 2) for n, g in named_grads if n in specs), zero)
    pdist.all_reduce_(split, axis)
    return sum((torch.sum(g.float() ** 2) for n, g in named_grads if n not in specs), zero) + split
