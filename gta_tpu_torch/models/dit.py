"""DiT with 2D geometric transform attention (the DiT family).

Port of gta_tpu/models/dit.py: an adaLN-Zero diffusion transformer over
[B, H, W, C] (NHWC) images whose self-attention is 2D GTA (per-token SO(2)
rotors over patch coordinates acting on q, k and v inside attention, with
an SO(2) + trivial `f_dims` split), replacing the stock additive sin/cos
positional table; `method: ''` keeps the stock DiT (frozen sin/cos table,
plain attention) as the baseline.

Parameter names follow the flax modules (`patch_embed`, `t_embed.fc1`,
`y_embed.table`, `block_{i}.ada_mod`, `block_{i}.attn.to_qkv`,
`block_{i}.mlp_fc1`, `final_mod`, `final_proj`, ...), so
`weights.params_from_jax` carries a JAX DiT's params over one to one.

Attention routes as the JAX module does on a TPU (`AttnConfig.fused`, set
by gta_tpu/train/dit_trainer.py:86-96): GTA without euclid_sim through
ops/gta_pallas.fused_gta_attention (rotor-only reps: the fused GTA
kernels), GTA with euclid_sim through ops/gta.gta_attention in torch eager
(with the plain dot-product similarity, as gta_tpu/models/dit.py:162-171
calls it), method '' through ops/flash (flash_core). The rotor tables are
built once per forward and shared by every block.

Numerics under a bf16 compute dtype follow the TPU's rounding as
tests/test_torch_bf16_layers.py states it: parameters stay fp32;
`Linear`/`Conv2d` (models/layers.py) round their fp32-accumulated product
to bf16, then add the bias in bf16; the LayerNorms are flax's defaults
(eps 1e-6, no scale, no bias; fp32 statistics, bf16 out); GELU is the tanh
approximation. Each elementwise chain XLA fuses on a TPU computes in fp32
from its bf16 operands and rounds once: GELU and SiLU (torch's bf16
kernels do), the modulation `x * (1 + scale) + shift` (`_modulate`) and
the gated residuals `x + gate * h` (`_gated`). The conditioning
`c = t_embed + y_embed` is one bf16 add; the timestep features are fp32
[cos, sin], cast after. The output is fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gta_tpu_torch.config import AttnConfig
from gta_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, init_weights, set_compute_dtype, tagged
from gta_tpu_torch.ops.attention import at_least_fp32, dot_product_attention
from gta_tpu_torch.ops.flash import flash_attention
from gta_tpu_torch.ops.flash_core import merge_heads, split_heads
from gta_tpu_torch.ops.gta import gta_attention
from gta_tpu_torch.ops.gta_pallas import fused_gta_attention
from gta_tpu_torch.ops.reps import GeomReps, encoder_reps

LN_EPS = 1e-6  # flax nn.LayerNorm's default (the NVS layers pin 1e-5)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Static DiT hyper-parameters (DiT-S/2-like defaults)."""

    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout: float = 0.1
    learn_sigma: bool = True
    attn: AttnConfig = AttnConfig()
    # diffusion schedule (train/diffusion.py)
    timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 2e-2
    vb_weight: float = 1.0

    @property
    def grid(self) -> int:
        if self.input_size % self.patch_size:
            raise ValueError(f"input_size {self.input_size} is not a multiple of patch_size {self.patch_size}")
        return self.input_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @property
    def null_label(self) -> int:
        return self.num_classes


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features [B, dim], fp32 [cos, sin] (DDPM
    convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def sincos_pos_embed(grid: int, dim: int) -> np.ndarray:
    """Frozen 2D sin/cos positional table [grid*grid, dim] (stock DiT),
    built in float64: the row half, then the column half."""
    if dim % 4:
        raise ValueError(f"the sin/cos table needs a width divisible by 4, got {dim}")
    quarter = dim // 4
    omega = 1.0 / 10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter)
    out = np.einsum("p,f->pf", np.arange(grid, dtype=np.float64), omega)  # [grid, quarter]
    emb_1d = np.concatenate([np.sin(out), np.cos(out)], -1)  # [grid, dim/2]
    emb_h = np.repeat(emb_1d[:, None], grid, 1)  # varies along rows
    emb_w = np.repeat(emb_1d[None], grid, 0)  # varies along columns
    return np.concatenate([emb_h, emb_w], -1).reshape(grid * grid, dim).astype(np.float32)


def _modulate(x, shift, scale):
    """x * (1 + scale) + shift over tokens [B, T, C] with per-item [B, C]
    shift and scale, as the TPU's fused chain rounds it
    (gta_tpu/models/dit.py:132): one addcmul over x and the fp32 (at least)
    1 + scale and shift, computed in fp32 and rounded once to x's dtype."""
    shift, scale = at_least_fp32(shift)[:, None], at_least_fp32(scale)[:, None]
    return torch.addcmul(shift, x, 1.0 + scale).to(x.dtype)


class _Gated(torch.autograd.Function):
    """x + gate[:, None] * h as one addcmul (fp32 inside, rounded once to
    the operands' dtype), whose VJP rounds each cotangent once as well: dx
    is g, dh the product g * gate rounded once, and dgate the sum of g * h
    over the tokens accumulated in fp32 and rounded once, where autograd's
    addcmul rounds each product g * h before the sum. dgate is the diagonal
    of the batched product g^T h ([B, C, C]): one GEMM over the operands as
    they lie (an einsum's batched dot copies both to another layout
    first, which cost more than the rest of the gated residual)."""

    @staticmethod
    def forward(ctx, x, gate, h):
        ctx.save_for_backward(gate, h)
        return torch.addcmul(x, gate[:, None], h)

    @staticmethod
    def backward(ctx, g):
        gate, h = ctx.saved_tensors
        return g, torch.bmm(g.transpose(1, 2), h).diagonal(dim1=1, dim2=2), g * gate[:, None]


def _gated(x, gate, h):
    """The adaLN-Zero gated residual x + gate * h ([B, T, C], gate [B, C]),
    as a TPU fuses it (gta_tpu/models/dit.py:195,203), forward and backward
    (`_Gated`)."""
    return _Gated.apply(x, gate, h)


def _layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=LN_EPS, elementwise_affine=False)


def _dense(i: int, o: int, scheme: str = "jax") -> Linear:
    return tagged(Linear(i, o), scheme)


def grid_reps(cfg: DiTConfig, batch: int, device) -> Optional[GeomReps]:
    """The rotor tables every block's attention shares: the patch
    coordinates of one view of grid x grid tokens (None for method ''),
    geometry/coords.make_2dcoord(grid, grid) made on the device (no host
    copy, which would wait for the device on every forward)."""
    if not cfg.attn.is_gta:
        return None
    g = cfg.grid
    i = torch.arange(g, dtype=torch.float32, device=device) / g
    coord = torch.stack(torch.meshgrid(i, i, indexing="ij"), -1).reshape(1, 1, g * g, 2)
    return encoder_reps(cfg.attn.gta, input_coord=coord.expand(batch, 1, g * g, 2))


class TimestepEmbedder(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, hidden_size: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1 = _dense(freq_dim, hidden_size)
        self.fc2 = _dense(hidden_size, hidden_size)

    def forward(self, t):
        x = timestep_embedding(t, self.freq_dim).to(self.compute_dtype)
        return self.fc2(F.silu(self.fc1(x)))


class LabelEmbedder(nn.Module):
    """Class-label table with a null row (index num_classes) for CFG. Label
    dropout is a mask the caller draws (`drop`: True where the label goes
    to the null row); none without one."""

    compute_dtype = torch.float32

    def __init__(self, num_classes: int, hidden_size: int):
        super().__init__()
        self.num_classes = num_classes
        self.table = tagged(nn.Embedding(num_classes + 1, hidden_size), "embed")

    def forward(self, y, drop: Optional[torch.Tensor] = None):
        if drop is not None:
            y = torch.where(drop, torch.full_like(y, self.num_classes), y)
        # the table cast to the compute dtype, as flax's Embed promotes it, and
        # looked up in fp32: a label that repeats sums its rows' cotangents in
        # fp32, and the cast's VJP rounds the sum once
        return F.embedding(y, self.table.weight.to(self.compute_dtype).float()).to(self.compute_dtype)


class GTASelfAttention(nn.Module):
    """Self-attention with per-token 2D group reps applied to q, k and v
    (or plain attention for method '')."""

    def __init__(self, dim: int, heads: int, attn: AttnConfig):
        super().__init__()
        self.heads = heads
        self.attn = attn
        self.scale = (dim // heads) ** -0.5
        self.to_qkv = _dense(dim, 3 * dim)
        self.to_out = _dense(dim, dim)

    def forward(self, x, reps: Optional[GeomReps]):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        cfg = self.attn
        if cfg.is_gta and not cfg.gta.euclid_sim:
            out = fused_gta_attention(q, k, v, self.heads, reps, cfg.gta, None, self.scale)
        elif cfg.is_gta:
            fn = lambda q, k, v: dot_product_attention(q, k, v, self.scale)  # noqa: E731
            out = merge_heads(gta_attention(*(split_heads(t, self.heads) for t in (q, k, v)), fn, reps, cfg.gta)[0])
        else:
            out = flash_attention(q, k, v, self.heads, self.scale)
        return self.to_out(out)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block: the conditioning regresses per-branch
    shift / scale / gate, zero-initialised so each block starts as the
    identity."""

    def __init__(self, hidden_size: int, heads: int, mlp_ratio: float, attn: AttnConfig):
        super().__init__()
        mlp_dim = int(hidden_size * mlp_ratio)
        self.ada_mod = _dense(hidden_size, 6 * hidden_size, "zeros")
        self.norm1 = _layer_norm(hidden_size)
        self.attn = GTASelfAttention(hidden_size, heads, attn)
        self.norm2 = _layer_norm(hidden_size)
        self.mlp_fc1 = _dense(hidden_size, mlp_dim)
        self.mlp_fc2 = _dense(mlp_dim, hidden_size)

    def forward(self, x, c, reps):
        s1, g1, gate1, s2, g2, gate2 = self.ada_mod(F.silu(c)).chunk(6, dim=-1)
        x = _gated(x, gate1, self.attn(_modulate(self.norm1(x), s1, g1), reps))
        h = self.mlp_fc1(_modulate(self.norm2(x), s2, g2))
        h = F.gelu(h, approximate="tanh")
        return _gated(x, gate2, self.mlp_fc2(h))


class DiT(nn.Module):
    """Diffusion transformer over [B, H, W, C] images (NHWC): returns the
    fp32 prediction [B, H, W, out_channels] (eps, then the raw variance
    channels with learn_sigma)."""

    compute_dtype = torch.float32

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        p, hid = cfg.patch_size, cfg.hidden_size
        self.patch_embed = tagged(Conv2d(cfg.in_channels, hid, p, stride=p), "jax")
        if not cfg.attn.is_gta:
            # stock DiT: a frozen sin/cos absolute table; GTA replaces it
            self.register_buffer("pos_embed", torch.from_numpy(sincos_pos_embed(cfg.grid, hid)), persistent=False)
        self.t_embed = TimestepEmbedder(hid)
        self.y_embed = LabelEmbedder(cfg.num_classes, hid)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", DiTBlock(hid, cfg.heads, cfg.mlp_ratio, cfg.attn))
        self.final_mod = _dense(hid, 2 * hid, "zeros")
        self.final_norm = _layer_norm(hid)
        self.final_proj = _dense(hid, p * p * cfg.out_channels, "zeros")

    def forward(self, x, t, y, drop: Optional[torch.Tensor] = None):
        """x [B, H, W, C] images, t [B] integer timesteps, y [B] labels;
        `drop` [B] bool, the label dropout mask (None: no dropout)."""
        cfg = self.cfg
        d = self.compute_dtype
        B = x.shape[0]
        p, g = cfg.patch_size, cfg.grid
        h = self.patch_embed(x.permute(0, 3, 1, 2).to(d))  # [B, hidden, g, g]
        h = h.flatten(2).transpose(1, 2)  # [B, g*g, hidden], row-major patches
        if not cfg.attn.is_gta:
            h = h + self.pos_embed.to(d)
        c = self.t_embed(t) + self.y_embed(y, drop)
        reps = grid_reps(cfg, B, x.device)
        for i in range(cfg.depth):
            h = getattr(self, f"block_{i}")(h, c, reps)
        shift, scale = self.final_mod(F.silu(c)).chunk(2, dim=-1)
        h = self.final_proj(_modulate(self.final_norm(h), shift, scale))
        # unpatchify [B, g*g, p*p*C] -> [B, H, W, C]
        h = h.reshape(B, g, g, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(B, g * p, g * p, cfg.out_channels).float()


def build_dit(cfg: DiTConfig, dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None) -> DiT:
    """The DiT of `cfg`, computing in `dtype` with fp32 parameters, its
    weights drawn as flax draws them (lecun-normal Dense and Conv kernels,
    zero biases, the Embed default, zeros for the adaLN-Zero layers) from
    `generator` (seed 0 by default)."""
    if cfg.attn.is_gta:
        fd, head_dim = cfg.attn.gta.f_dims, cfg.hidden_size // cfg.heads
        if fd.total != head_dim:
            raise ValueError(f"f_dims total {fd.total} != head dim {head_dim}")
        cfg.attn.gta.validate()
    model = DiT(cfg)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return set_compute_dtype(model, dtype)
