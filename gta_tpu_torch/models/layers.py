"""Building blocks: weight init schemes, the compute-dtype layers, feed-forward,
the Attention layer and the pre-LN Transformer.

Parameter names follow the reference PyTorch implementation's state_dict
keys (layers.{i}.0.norm, layers.{i}.0.fn.to_qkv, layers.{i}.1.fn.net.0, ...)
so weights carry across frameworks by a fixed key map (weights.py).

Compute dtype (the JAX package's `dtype=` module attribute,
gta_tpu/models/layers.py:8-9): parameters stay fp32 whatever it is. A module
with a `compute_dtype` attribute (set for a whole model by
`set_compute_dtype`) computes in it: `Linear` and `Conv2d` cast their input
and weight to it, accumulate in fp32 and add the bias in it (flax
Dense/Conv with `dtype=`), `LayerNorm` takes its statistics in fp32 and
returns it, and the attention kernels take q, k and v in it with their
rep tables in fp32. Softmax stays fp32 (inside the kernels); so do the
pixels and the loss (models/decoder.py, train/trainer.py). The residual
stream is in the compute dtype, as in JAX. Unlike torch.autocast, this
keeps LayerNorm outputs and residual adds in bf16 where JAX has them.
fp32, the default, casts nothing: the modules are torch's own, so a model
a caller converts (as chip_smoke.py's fp64 reference step does) computes
in its own dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gta_tpu_torch.config import AttnConfig
from gta_tpu_torch.models.context import AttnContext
from gta_tpu_torch.ops.flash import flash_attention
from gta_tpu_torch.ops.gta_fused import fused_gta_attention_tokens

# ---------------------------------------------------------------------------
# Initialization schemes (reference layers.py:14-49), drawn from a
# torch.Generator so a seed fixes every weight:
#   jax    = trunc-normal std sqrt(1/fan_in) (flax lecun_normal), bias zeros
#   vit    = xavier uniform, bias ~ N(0, 1e-6)
#   srt    = xavier uniform, bias zeros
# Modules are tagged with their scheme at construction; `init_weights`
# draws them in module order.
# ---------------------------------------------------------------------------


def tagged(module: nn.Module, scheme: str) -> nn.Module:
    module.init_scheme = scheme
    return module


def _lecun_normal_(w: torch.Tensor, g: torch.Generator):
    fan_in = w[0].numel()  # Linear [out, in] and Conv [out, in, kh, kw]
    # 0.8796... is the std of a unit normal truncated to [-2, 2] (flax's
    # variance_scaling correction)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


def _init_module(m: nn.Module, scheme: str, g: torch.Generator):
    if scheme == "jax":
        _lecun_normal_(m.weight, g)
        if m.bias is not None:
            nn.init.zeros_(m.bias)
    elif scheme in ("vit", "srt"):
        nn.init.xavier_uniform_(m.weight, generator=g)
        if m.bias is not None:
            if scheme == "vit":
                nn.init.normal_(m.bias, std=1e-6, generator=g)
            else:
                nn.init.zeros_(m.bias)
    elif scheme == "const_emb":
        nn.init.normal_(m.initial_emb, std=1.0, generator=g)
    else:
        raise ValueError(f"unknown init scheme {scheme}")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """(Re)draw every tagged parameter of `model` from `generator`;
    LayerNorms reset to ones/zeros."""
    for m in model.modules():
        scheme = getattr(m, "init_scheme", None)
        if scheme is not None:
            _init_module(m, scheme, generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return model


def to_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in the compute dtype `dtype`; fp32 leaves x as it is (module
    docstring)."""
    return x if dtype == torch.float32 else x.to(dtype)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], shape) -> torch.Tensor:
    """y + bias in y's dtype (flax adds the bias after the product, each
    result rounded to the compute dtype)."""
    return y if bias is None else y + bias.to(y.dtype).reshape(shape)


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (flax Dense with `dtype=`):
    input and weight cast to it, the product accumulated in fp32 and
    rounded to it, then the bias added in it."""

    compute_dtype = torch.float32

    def forward(self, x):
        d = self.compute_dtype
        if d == torch.float32:
            return super().forward(x)
        return _add_bias(F.linear(x.to(d), self.weight.to(d)), self.bias, (-1,))


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` (flax Conv with `dtype=`), as
    `Linear` does."""

    compute_dtype = torch.float32

    def forward(self, x):
        d = self.compute_dtype
        if d == torch.float32:
            return super().forward(x)
        return _add_bias(self._conv_forward(x.to(d), self.weight.to(d), None), self.bias, (-1, 1, 1))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with fp32 statistics and affine, output in
    `compute_dtype` (flax LayerNorm with `dtype=`)."""

    compute_dtype = torch.float32

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every module of `model` that has a compute dtype compute in
    `dtype`; parameters keep theirs (fp32)."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


class Dropout(nn.Module):
    """Inverted dropout (flax nn.Dropout semantics: keep with probability
    1 - p, scale kept values by 1 / (1 - p)) whose masks are drawn from an
    explicit torch.Generator, never from torch's global RNG. The Trainer
    owns that generator and hands it to every Dropout of its model
    (`set_dropout_generator`). Identity in eval mode and at p = 0."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator (set_dropout_generator)")
        # the mask is drawn in fp32 whatever x's dtype
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep / (1.0 - self.p)


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every Dropout mask of `model` from `generator`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class FeedForward(nn.Module):
    """Linear-GELU-Linear with ViT init (reference layers.py:157-169);
    GELU is the exact erf form."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            tagged(Linear(dim, hidden_dim), "vit"),
            nn.GELU(),
            Dropout(dropout),
            tagged(Linear(hidden_dim, dim), "vit"),
            Dropout(dropout),
        )

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """Attention layer for methods 'gta' and '' (plain dot product).

    kv_dim None => self-attention (fused to_qkv projection); otherwise
    cross-attention over z (to_q / to_kv). GTA runs through the fused
    kernels (ops/gta_fused), method '' through flash attention
    (ops/flash, the flash_core kernels), as the JAX package's layers do on
    a TPU: the plain versions on CPU tensors, the CUDA kernels on CUDA
    tensors. q, k and v come out of the projections in the compute dtype;
    trans_coeff is cast to it before it enters the fp32 rep tables, as
    JAX's `.astype(self.dtype)` does.
    """

    compute_dtype = torch.float32

    def __init__(
        self,
        dim: int,
        heads: int = 8,
        dim_head: int = 64,
        dropout: float = 0.0,
        kv_dim: Optional[int] = None,
        attn: AttnConfig = AttnConfig(),
    ):
        super().__init__()
        if attn.method not in ("gta", ""):
            raise NotImplementedError(
                f"attention method {attn.method!r} is not ported yet (ROADMAP queue 1, other attention methods)"
            )
        if attn.softmax != "standard" or attn.rpe:
            raise NotImplementedError(
                "adjustable softmax / rpe are not ported yet (ROADMAP queue 1, other attention methods)"
            )
        self.heads = heads
        self.attn = attn
        self.scale = dim_head**-0.5
        inner = dim_head * heads
        if kv_dim is None:
            self.to_qkv = tagged(Linear(dim, 3 * inner, bias=attn.use_bias), "jax")
        else:
            self.to_q = tagged(Linear(dim, inner, bias=attn.use_bias), "jax")
            self.to_kv = tagged(Linear(kv_dim, 2 * inner, bias=attn.use_bias), "jax")
        if attn.is_gta and attn.gta.f_dims.se3 > 0:
            self.trans_coeff = nn.Parameter(torch.full((1,), 0.01))
        else:
            self.trans_coeff = None
        if heads == 1 and dim_head == dim:
            self.to_out = nn.Identity()
        else:
            self.to_out = nn.Sequential(tagged(Linear(inner, dim), "jax"), Dropout(dropout))

    def forward(self, x, z=None, ctx: Optional[AttnContext] = None):
        if z is None:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        else:
            q = self.to_q(x)
            k, v = self.to_kv(z).chunk(2, dim=-1)
        if self.attn.is_gta:
            tc = None if self.trans_coeff is None else to_compute(self.trans_coeff, self.compute_dtype)
            out = fused_gta_attention_tokens(q, k, v, self.heads, ctx.geom, self.attn.gta, tc, self.scale)
        else:
            out = flash_attention(q, k, v, self.heads, self.scale)
        return self.to_out(out)


class PreNorm(nn.Module):
    """LayerNorm (eps 1e-5) applied to the input of `fn` only."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.norm(x), **kwargs)


class Transformer(nn.Module):
    """Pre-LN stack: x += attn(LN(x), z); x += ff(LN(x)).

    z (cross-attention memory) is intentionally *not* normalized, matching
    reference layers.py:146-154/475-488.
    """

    def __init__(
        self,
        dim: int,
        depth: int,
        heads: int,
        dim_head: int,
        mlp_dim: int,
        dropout: float = 0.0,
        kv_dim: Optional[int] = None,
        attn: AttnConfig = AttnConfig(),
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList(
                [
                    PreNorm(dim, Attention(dim, heads, dim_head, dropout, kv_dim, attn)),
                    PreNorm(dim, FeedForward(dim, mlp_dim, dropout)),
                ]
            )
            for _ in range(depth)
        )

    def forward(self, x, z=None, ctx: Optional[AttnContext] = None):
        for attn, ff in self.layers:
            x = x + attn(x, z=z, ctx=ctx)
            x = x + ff(x)
        return x
