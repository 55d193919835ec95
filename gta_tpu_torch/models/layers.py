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
An elementwise chain that XLA fuses on a TPU (mln's FiLM, `film`; repast's
scaled scores) computes in fp32 from its operands and rounds once, at its
end (the convention tests/test_torch_bf16_layers.py states). fp32, the
default, casts nothing: the modules are torch's own, so a model a caller
converts (as chip_smoke.py's fp64 reference step does) computes in its
own dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gta_tpu_torch.config import AttnConfig
from gta_tpu_torch.geometry.se3 import se3_inverse
from gta_tpu_torch.models.context import AttnContext
from gta_tpu_torch.ops.attention import at_least_fp32, dot_product_attention, euclid_attention
from gta_tpu_torch.ops.flash import flash_attention
from gta_tpu_torch.ops.flash_core import merge_heads, split_heads
from gta_tpu_torch.ops.gta import gta_attention, vecrep_attention
from gta_tpu_torch.ops.gta_pallas import fused_gta_attention
from gta_tpu_torch.parallel import dist as pdist
from gta_tpu_torch.parallel.ring import ring_gta_attention
from gta_tpu_torch.parallel.tp import column_parallel, copy_in, row_parallel

# ---------------------------------------------------------------------------
# Initialization schemes (reference layers.py:14-49), drawn from a
# torch.Generator so a seed fixes every weight:
#   jax    = trunc-normal std sqrt(1/fan_in) (flax lecun_normal), bias zeros
#   vit    = xavier uniform, bias ~ N(0, 1e-6)
#   srt    = xavier uniform, bias zeros
#   zeros  = weight and bias zeros (the DiT's adaLN-Zero layers)
#   embed  = normal std sqrt(1/features) (flax nn.Embed's default)
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
    elif scheme == "zeros":
        nn.init.zeros_(m.weight)
        nn.init.zeros_(m.bias)
    elif scheme == "embed":
        nn.init.normal_(m.weight, std=math.sqrt(1.0 / m.weight.shape[1]), generator=g)
    else:
        raise ValueError(f"unknown init scheme {scheme}")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """(Re)draw every tagged parameter of `model` from `generator`;
    affine LayerNorms reset to ones/zeros."""
    for m in model.modules():
        scheme = getattr(m, "init_scheme", None)
        if scheme is not None:
            _init_module(m, scheme, generator)
        elif isinstance(m, nn.LayerNorm) and m.elementwise_affine:
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


def film(g: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """FiLM g * x + b, as a TPU fuses the chain (gta_tpu/models/layers.py:
    273-284): one addcmul, which computes in fp32 (at least) and rounds
    once to the operands' dtype."""
    return torch.addcmul(b, g, x)


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
    (`set_dropout_generator`). Identity in eval mode and at p = 0.

    `shards` ((dim, index, count), ...) marks an input that is block
    `index` of `count` along `dim` of the whole activation (a model rank's
    hidden units, a seq rank's tokens: parallel/tp.py, parallel/ring.py):
    the mask of the whole activation is drawn and the block kept, so the
    generator moves as in one process and the masks are one process's."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.shards: Tuple[Tuple[int, int, int], ...] = ()

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator (set_dropout_generator)")
        shape = list(x.shape)
        for dim, _, count in self.shards:
            shape[dim] *= count
        # the mask is drawn in fp32 whatever x's dtype
        keep = torch.rand(shape, generator=self.generator, device=x.device) >= self.p
        for dim, index, _ in self.shards:
            n = x.shape[dim]
            keep = keep.narrow(dim, index * n, n)
        return x * keep / (1.0 - self.p)


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every Dropout mask of `model` from `generator`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class FeedForward(nn.Module):
    """Linear-GELU-Linear with ViT init (reference layers.py:157-169);
    GELU is the exact erf form. Under tensor parallel (`tp`, the model
    axis: parallel/tp.py) the rank holds a block of the hidden units."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            tagged(Linear(dim, hidden_dim), "vit"),
            nn.GELU(),
            Dropout(dropout),
            tagged(Linear(hidden_dim, dim), "vit"),
            Dropout(dropout),
        )
        self.tp = None

    def forward(self, x):
        if self.tp is None:
            return self.net(x)
        up, act, drop, down, drop_out = self.net
        h = drop(act(column_parallel(up, x, self.tp, up.compute_dtype)))
        return drop_out(row_parallel(down, h, self.tp, down.compute_dtype))


class _Attend(nn.Module):
    """The adjustable softmax's learnable temperature (reference
    layers.py:135-143; its state_dict key `attend.tau`), initialised to 1."""

    def __init__(self):
        super().__init__()
        self.tau = nn.Parameter(torch.ones(1))


def _rpe_init(heads: int, so2: int) -> torch.Tensor:
    """rpe's per-head rep vectors [heads, 16 + 4 so2]: a flattened 4x4
    identity, then (1, 0) per SO(2) column (reference layers.py:257-264)."""
    base = torch.cat([torch.eye(4).reshape(-1), torch.tensor([1.0, 0.0]).repeat(so2 * 2)])
    return base[None].repeat(heads, 1)


class Attention(nn.Module):
    """Multi-method attention layer (gta_tpu/models/layers.py `Attention`):
    'gta' (and its elementwise_mul / euclid ablations), plain dot product
    (''), 'ape', 'mln', 'gbt' (a Plücker-distance bias), 'repast' (queries
    augmented per key view), 'frustum_posemb', and rpe's learned rep vectors
    ('invatt_directsum').

    kv_dim None => self-attention (fused to_qkv projection); otherwise
    cross-attention over z (to_q / to_kv). The layer routes as the JAX
    package's layers do on a TPU: GTA with a static tau and neither
    euclid_sim nor elementwise_mul through the GTA kernels
    (ops/gta_pallas.fused_gta_attention: the fused GTA kernels, or the
    sliced transforms around flash_core); a `flash_eligible` other method
    ('', ape, mln, frustum_posemb under the standard softmax) through flash
    attention (ops/flash, the flash_core kernels); everything else (an
    adjustable tau, euclid, elementwise_mul, gbt, repast, rpe) in torch
    eager with its attention map (ops/attention), as JAX computes those
    with XLA. A layer of a Transformer that returns its last attention map
    (`keep_map`, the decoder's return_last_attmap) attends eagerly whatever
    its method, as JAX keeps such a module off flash, the fused kernels and
    the ring (gta_tpu/config.py:271,299). q, k and v come out of the
    projections in the compute dtype; trans_coeff and tau are cast to it, as
    JAX's `.astype(self.dtype)` does. Where tensor parallel splits the
    layer (`tp`, parallel/tp.py) every route attends on the rank's block of
    heads, and a returned map is gathered over the model axis.
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
        method = attn.method
        if method not in ("gta", "", "ape", "mln", "gbt", "repast", "frustum_posemb", "invatt_directsum"):
            raise ValueError(f"unknown attention method {method!r}")
        self.heads = heads
        self.attn = attn
        self.keep_map = False  # set by a Transformer that returns its last attention map
        self.scale = dim_head**-0.5
        inner = dim_head * heads
        kvd = dim if kv_dim is None else kv_dim
        lin = lambda i, o, bias=attn.use_bias: tagged(Linear(i, o, bias=bias), "jax")  # noqa: E731
        self.attend = _Attend() if attn.softmax == "adjustable" else None
        self.trans_coeff = None
        self.tp = None  # the model axis, where it splits the layer (parallel/tp.shard_model)
        self.seq = None  # the seq axis, where the layer rings (parallel/ring.shard_model)
        if method == "repast":
            self.to_q = lin(dim + attn.q_emb_dim, inner)
            self.to_k = lin(kvd + attn.k_emb_dim, inner)
            self.to_v = lin(kvd + attn.k_emb_dim if attn.v_bias else kvd, inner)
            self.to_out = nn.Sequential(lin(inner, dim, True), Dropout(dropout))
            return
        emb = 180 + 16  # a coordinate embedding and a flattened 4x4 camera
        if method == "ape" and kv_dim is None:
            self.linear = lin(emb, dim, True)
        elif method == "ape":
            self.linear_q, self.linear_k = lin(emb, dim, True), lin(emb, kv_dim, True)
        elif method == "mln" and kv_dim is None:
            self.linear_g, self.linear_b = lin(emb, dim, True), lin(emb, dim, True)
        elif method == "mln":
            self.linear_q_g, self.linear_q_b = lin(emb, dim, True), lin(emb, dim, True)
            self.linear_k_g, self.linear_k_b = lin(emb, kv_dim, True), lin(emb, kv_dim, True)
        if kv_dim is None:
            self.to_qkv = lin(dim, 3 * inner)
        else:
            self.to_q = lin(dim, inner)
            self.to_kv = lin(kv_dim, 2 * inner)
        if attn.rpe:
            init = _rpe_init(heads, attn.rpe_so2)
            self.q_bias, self.k_bias, self.v_bias = (nn.Parameter(init.clone()) for _ in range(3))
            inner += heads * init.shape[1]  # to_out's input grows by the rep vectors
        if method == "gbt":
            self.geo_weights = nn.Parameter(torch.ones(1))
        gta = attn.gta
        if attn.is_gta and gta.elementwise_mul:
            fd = gta.f_dims
            flat = 4 * gta.n_so2_rotors * (fd.so2 > 0) + 16 * (fd.se3 > 0)
            self.rep_to_vec = lin(flat, dim_head, True)
        elif attn.is_gta and gta.f_dims.se3 > 0:
            self.trans_coeff = nn.Parameter(torch.full((1,), 0.01))
        if heads == 1 and dim_head == dim:
            self.to_out = nn.Identity()
        else:
            self.to_out = nn.Sequential(lin(inner, dim, True), Dropout(dropout))

    def _tau(self):
        return 1.0 if self.attend is None else self._shared(to_compute(self.attend.tau, self.compute_dtype))

    def _shared(self, t):
        """A head-independent tensor used inside the rank's heads: under
        tensor parallel its gradient sums over the model axis
        (parallel/tp.copy_in)."""
        return t if self.tp is None else copy_in(t, self.tp)

    def route(self) -> str:
        """How the layer attends: 'gta' (the GTA kernels: a static tau and
        neither euclid_sim nor elementwise_mul), 'flash' (flash_core: a
        `flash_eligible` other method), 'repast', or 'eager' (torch eager
        with its attention map, as JAX computes it with XLA; every method
        but repast under `keep_map`)."""
        if self.attn.method == "repast":
            return "repast"
        static = self.attend is None and not self.attn.rpe and not self.keep_map
        gta = self.attn.gta
        if self.attn.is_gta and static and not gta.euclid_sim and not gta.elementwise_mul:
            return "gta"
        return "flash" if static and self.attn.flash_eligible else "eager"

    def _project(self, linear, x):
        """An input projection: this model rank's block of heads under
        tensor parallel (parallel/tp.py), all of them otherwise."""
        return linear(x) if self.tp is None else column_parallel(linear, x, self.tp, linear.compute_dtype)

    def _out(self, out):
        """to_out on the heads' output: the rank's rows of it summed over
        the model axis under tensor parallel (parallel/tp.row_parallel)."""
        if self.tp is None:
            return self.to_out(out)
        linear, dropout = self.to_out
        return dropout(row_parallel(linear, out, self.tp, linear.compute_dtype))

    def _whole_map(self, attmap):
        """The attention map of every head: the model ranks' heads gathered
        under tensor parallel."""
        return attmap if self.tp is None else pdist.gather_blocks(attmap, self.tp, 1)

    def forward(self, x, z=None, ctx: Optional[AttnContext] = None, return_attmap: bool = False):
        """The layer's output; with `return_attmap` (the eager and repast
        routes), (output, attention probabilities [B, H, Tq, Tk])."""
        route = self.route()
        if route == "repast":
            out, attmap = self._repast(x, z, ctx)
            out = self._out(out)
            return (out, self._whole_map(attmap)) if return_attmap else out
        if return_attmap and route != "eager":
            raise ValueError(f"the {route!r} route keeps no attention map")
        if self.attn.method == "ape":
            x, z = self._ape(x, z, ctx)
        elif self.attn.method == "mln":
            x, z = self._mln(x, z, ctx)
        if z is None:
            q, k, v = self._project(self.to_qkv, x).chunk(3, dim=-1)
        else:
            q = self._project(self.to_q, x)
            k, v = self._project(self.to_kv, z).chunk(2, dim=-1)
        if route == "gta":
            gta = self.attn.gta
            tc = None if self.trans_coeff is None else self._shared(to_compute(self.trans_coeff, self.compute_dtype))
            if self.seq is not None:
                q, k, v = (split_heads(t, self.heads) for t in (q, k, v))
                out = merge_heads(ring_gta_attention(q, k, v, ctx.geom, gta, tc, self.scale, self.seq, z is None))
            else:
                out = fused_gta_attention(q, k, v, self.heads, ctx.geom, gta, tc, self.scale)
        elif route == "flash":
            out = flash_attention(q, k, v, self.heads, self.scale)
        else:
            out, attmap = self._eager(*(split_heads(t, self.heads) for t in (q, k, v)), ctx, self._tau())
            out = merge_heads(out)
        out = self._out(out)
        return (out, self._whole_map(attmap)) if return_attmap else out

    def _eager(self, q, k, v, ctx, tau):
        """The methods JAX computes with XLA, over heads-first [B, H, T, C]
        (the rank's heads under tensor parallel): (output, attention
        probabilities)."""
        if self.attn.rpe:
            q, k, v = (
                torch.cat([t, to_compute(b, self.compute_dtype).to(t.dtype)[None, :, None].expand(
                    t.shape[0], -1, t.shape[2], -1)], -1)
                for t, b in ((q, self.q_bias), (k, self.k_bias), (v, self.v_bias))
            )
        if not self.attn.is_gta:
            bias = None
            if self.attn.method == "gbt":
                bias = -((self._shared(self.geo_weights) ** 2) * ctx.plucker_dist)[:, None]
            return dot_product_attention(q, k, v, self.scale, tau, bias)
        gta = self.attn.gta
        if gta.elementwise_mul:
            geom = ctx.geom
            vec_q, vec_k, vec_q_inv = (self._shared(self.rep_to_vec(to_compute(f, self.compute_dtype)))
                                       for f in (geom.flat_q, geom.flat_k, geom.flat_q_inv))
            fn = lambda q, k, v: dot_product_attention(q, k, v, self.scale, tau)  # noqa: E731
            return vecrep_attention(q, k, v, fn, vec_q, vec_k, vec_q_inv)
        tc = None if self.trans_coeff is None else self._shared(to_compute(self.trans_coeff, self.compute_dtype))
        attend = euclid_attention if gta.euclid_sim else dot_product_attention
        fn = lambda q, k, v: attend(q, k, v, self.scale, tau)  # noqa: E731
        return gta_attention(q, k, v, fn, ctx.geom, gta, tc)

    @staticmethod
    def _camera_emb(coord_emb: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
        """[B, N, T, 180] coordinate embedding and [B, N, 4, 4] cameras ->
        [B, N*T, 196]: the flattened camera, then the coordinates."""
        B, N, T, E = coord_emb.shape
        cam = transforms.reshape(B, N, 1, 16).expand(B, N, T, 16)
        return torch.cat([cam, coord_emb], -1).reshape(B, N * T, E + 16)

    def _ape(self, x, z, ctx):
        """Additive camera + coordinate embedding (reference layers.py:348-366)."""
        d = self.compute_dtype
        if z is None:
            return x + self.linear(to_compute(self._camera_emb(ctx.input_coord_emb, ctx.input_transforms), d)), z
        q_emb = self._camera_emb(ctx.target_coord_emb, ctx.target_transforms)
        k_emb = self._camera_emb(ctx.input_coord_emb, ctx.input_transforms)
        return x + self.linear_q(to_compute(q_emb, d)), z + self.linear_k(to_compute(k_emb, d))

    def _mln(self, x, z, ctx):
        """FiLM modulation by camera + coordinate embedding (reference
        layers.py:367-385). The reference inverts the cameras only on the
        cross-attention path (layers.py:372-374)."""
        d = self.compute_dtype
        if z is None:
            emb = to_compute(self._camera_emb(ctx.input_coord_emb, ctx.input_transforms), d)
            return film(self.linear_g(emb), x, self.linear_b(emb)), z
        q_emb = to_compute(self._camera_emb(ctx.target_coord_emb, se3_inverse(ctx.target_transforms)), d)
        k_emb = to_compute(self._camera_emb(ctx.input_coord_emb, se3_inverse(ctx.input_transforms)), d)
        return (film(self.linear_q_g(q_emb), x, self.linear_q_b(q_emb)),
                film(self.linear_k_g(k_emb), z, self.linear_k_b(k_emb)))

    def _repast(self, x, z, ctx):
        """Relative-pose attention (reference layers.py:294-346): queries
        augmented per key view with the rays re-expressed in each key view's
        frame; scores of a query against view n's keys use its view-n
        augmentation. Returns ([B, Tq, inner] ([B, Tq, Nk, inner] where the
        queries come augmented, as in the decoder), the probabilities)."""
        q = x
        q_is_aug = q.ndim == 4
        if q_is_aug:
            B, Tq, Nk = q.shape[:3]
        else:
            q_ray = ctx.query_ray_emb  # [B, Tq, Nk, E]
            B, Tq, Nk = q_ray.shape[:3]
            q = torch.cat([q[:, :, None].expand(B, Tq, Nk, q.shape[-1]), q_ray.to(q.dtype)], -1)
        kv = x if z is None else z
        k_ray = ctx.key_ray_emb  # [B, Nk, Lk, E]
        k_in = torch.cat([kv.reshape(*k_ray.shape[:-1], -1), k_ray.to(kv.dtype)], -1)
        v_in = k_in.reshape(kv.shape[0], kv.shape[1], -1) if self.attn.v_bias else kv
        H = self.heads
        q, k, v = self._project(self.to_q, q), self._project(self.to_k, k_in), self._project(self.to_v, v_in)
        q = q.reshape(*q.shape[:-1], H, -1).movedim(-2, 1)  # [B, H, Tq, Nk, C]
        k = k.reshape(*k.shape[:-1], H, -1).movedim(-2, 1)  # [B, H, Nk, Lk, C]
        v = split_heads(v, H)  # [B, H, Tk, C]
        # the scores round to the compute dtype as a product does; the chain
        # after them ends in fp32 (gta_tpu/models/layers.py:329-333), so it
        # computes there unrounded, as a TPU fuses it
        sim = at_least_fp32(torch.einsum("bhtnc,bhnlc->bhtnl", q, k).reshape(B, H, Tq, -1))
        if self.attn.enable_scale:
            sim = sim * self.scale
        attn = torch.softmax(sim / self._tau(), -1).to(v.dtype)
        out = merge_heads(torch.einsum("bhqk,bhkc->bhqc", attn, v))
        if q_is_aug:
            out = out[:, :, None].expand(B, Tq, Nk, out.shape[-1])
        return out, attn


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
    reference layers.py:146-154/475-488. With `return_last_attmap`, forward
    returns (x, the last block's attention probabilities [B, H, Tq, Tk]),
    and every block attends eagerly (`Attention.keep_map`), as JAX keeps
    such a module off its kernels and the ring (gta_tpu/models/layers.py
    `Transformer`, gta_tpu/config.py:271,299).
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
        return_last_attmap: bool = False,
    ):
        super().__init__()
        self.return_last_attmap = return_last_attmap
        self.layers = nn.ModuleList(
            nn.ModuleList(
                [
                    PreNorm(dim, Attention(dim, heads, dim_head, dropout, kv_dim, attn)),
                    PreNorm(dim, FeedForward(dim, mlp_dim, dropout)),
                ]
            )
            for _ in range(depth)
        )

        for attn, _ in self.layers:
            attn.fn.keep_map = return_last_attmap

    def forward(self, x, z=None, ctx: Optional[AttnContext] = None):
        attmap = None
        for i, (attn, ff) in enumerate(self.layers):
            if self.return_last_attmap and i == len(self.layers) - 1:
                out, attmap = attn(x, z=z, ctx=ctx, return_attmap=True)
            else:
                out = attn(x, z=z, ctx=ctx)
            x = x + out
            x = x + ff(x)
        return (x, attmap) if self.return_last_attmap else x
