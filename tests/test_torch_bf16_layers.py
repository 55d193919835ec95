"""The TPU's bf16 rounding, layer by layer: every bf16 layer and elementwise
chain of the port held to the JAX package's on the CPU, forward and
backward, each fed JAX's own input, so that no upstream difference carries
in.

The convention. The repo models a TPU's bf16 numerics (what a `mixed_prec`
config computes: gta_tpu/train/trainer.py:56) so:
  * a flax `Dense` / `Conv` output is the fp32-accumulated product of bf16
    operands rounded to bf16, then the bias added in bf16
    (models/layers.Linear, Conv2d);
  * a `LayerNorm` takes fp32 statistics and affine and rounds once
    (models/layers.LayerNorm); an `Embed` rounds its fp32 table to bf16;
  * an elementwise chain that XLA fuses rounds once, at its end, where an
    explicit `astype` or a module boundary counts as an end. XLA on the CPU
    rounds after each operation instead, so the JAX side takes the
    convention by monkeypatches only (tests/test_torch_bf16._tpu_numerics,
    tests/test_torch_dit._dit_numerics, `_nvs_numerics` and
    `_camera_planar_numerics` here). The chains on the bf16 paths, by JAX
    file and line, and the rounding each takes, on both sides:
      - GELU, erf (gta_tpu/models/layers.py:53) and tanh
        (gta_tpu/models/dit.py:201): fp32, rounded once;
      - SiLU (gta_tpu/models/dit.py:108, 189, 261): fp32, rounded once;
      - the DiT's modulation x * (1 + scale) + shift (:132, at :194, :198
        and the final layer's :263) and its gated residuals x + gate * h
        (:195, :203): fp32 from the bf16 operands, rounded once
        (models/dit._modulate, _gated);
      - the decoder's pixels `nn.sigmoid(h).astype(float32)`
        (gta_tpu/models/decoder.py:222-223): a chain that ends in fp32, so
        the sigmoid of the bf16 h in fp32, unrounded
        (models/decoder.render_pixels);
      - repast's scores `sim * scale / tau` before their cast to fp32
        (gta_tpu/models/layers.py:329-333; msn repast is a published bf16
        config): the product rounded to bf16, the rest in fp32;
      - mln's FiLM g * x + b (gta_tpu/models/layers.py:273-284, bf16 only
        under --bf16): fp32, rounded once (models/layers.film);
      - camera_planar's two adds after the stem, x + emb_2dpos + emb_cam
        (gta_tpu/models/encoder.py:177): fp32, rounded once
        (models/encoder.embed_camera_planar);
      - the eager GTA transforms (gta_tpu/ops/gta.py:404-449 and :473-501:
        `_apply_so2` -> geometry/so2.apply_rotor at :81, the se3 tables
        times `scale_mask` at :408, euclid's `homogenize` and einsum at
        :414-421; msn gta_so3_euclid's route, gta_tpu/models/layers.py
        _gta -> gta_attention). Settled from the code and measured: the rep
        tables are fp32 (and trans_coeff's mask takes its bf16 value
        exactly), so jnp's promotion makes every product of the chain fp32;
        the chain runs from the bf16 q, k, v through euclid_attention to
        to_out's input, which to_out's cast rounds once. No bf16 rounding
        sits inside it, on a TPU or on the CPU, and the forward needs no
        patch.
    A result of one operation (a residual add, ReLU, a cast of fp32 data)
    rounds the same either way and is not listed.

The backward (the VJP of each entry above), settled from the code and by
measuring both sides against an fp64 VJP rounded the same way
(`python -m tests.test_torch_bf16_layers` holds the measurements):
  * Dense / Conv: dx and the bf16 weight's cotangent are fp32-accumulated
    products rounded once to bf16; the cast of the fp32 weight, bias (and
    of an fp32 input: to_out after the eager GTA chain) carries the bf16
    cotangent back to fp32 unchanged, so a parameter's cotangent is
    compared in fp32 at bf16's precision. Measured: both sides' dx and
    dweight flip 1-2 of 10^4 elements, the fp32 accumulation order.
  * a bias's cotangent, and every cotangent that sums over broadcast axes
    (the DiT's shift, scale and gate, camera_planar's two embeddings, the
    label table over a repeated label), is summed in fp32 and rounded once.
    Measured: XLA on the CPU sums a bias's bf16 cotangent in bf16 (without
    excess precision: 67-82 % of the elements off the fp32 sum rounded
    once, up to 4 ulps), so JAX's Dense / Conv bias is added by
    `_add_bias`, a test-local jax.custom_vjp whose rule sums in fp32. The
    port's torch sums bf16 in fp32 (0 off), and its repairs: the gated
    residuals' gate (autograd's addcmul rounded each g * h before the sum:
    36 % off; now a batched dot accumulates it in fp32, models/dit._Gated)
    and the label table (an fp32 sum of repeated rows was left unrounded;
    now the table is cast before the lookup, models/dit.LabelEmbedder).
  * LayerNorm: fp32 inside, dx rounded once; its scale and offset
    cotangents are fp32 sums, as are the parameters. Measured: flax
    promotes the bf16 input twice (statistics, normalisation) and XLA on
    the CPU adds the two rounded cotangents in bf16 (29 % of dx off the
    fp64 VJP's rounding; the port's 0), so JAX's LayerNorm is applied to
    its input promoted once. The scale's cotangent is an fp32 sum that the
    two frameworks order differently (most elements differ, by up to 16
    fp32 ulps); held to 32 ulps, the offset's to one.
  * a chain's VJP rounds once, at the end of each operand's cotangent: the
    chain's operands enter it once. Measured: JAX's patched chains are fp32
    with one cast per operand; the eager GTA chain converted q, k, v and
    trans_coeff at each use on both sides (jnp and torch promote per
    operation) and added the rounded cotangents in bf16 (dtrans_coeff 4-16
    ulps apart). The port now promotes them once (ops/gta.sliced_operand),
    and JAX's gta_attention takes them promoted (`_nvs_numerics`); the
    chain is then fp32 from end to end, where the two frameworks' fp32
    orders alone flip 0.05-0.8 % of dq, dk, dv (each side 0.04-0.6 % off
    the fp64 VJP's rounding), held to 1.5 %.

The checks. The JAX bf16 forward of each config runs once under jit with
`flax.linen.intercept_methods` capturing every module call's arrays in and
out. Each flax Dense, Conv, LayerNorm and Embed maps to the port module of
the same name (weights.flax_path_to_torch_key); the port module takes
JAX's input and its output must have JAX's dtype, differ from JAX's in at
most a share SHARE[kind] of the elements, and differ nowhere by more than
one ulp (of the output's dtype) of the larger of JAX's element and the
tensor's RMS: the RMS term covers outputs that cancel toward zero, where a
Dense can be many ulps of the element off. Each chain runs as the port's
function on the bf16 operands captured from its neighbours (`_modulate`
takes norm1's output and ada_mod's chunks, its result is to_qkv's input)
and is held to the same rules. The backward: one cotangent per output
drawn with numpy (seed SEED_CT); JAX's VJP of each layer (the captured
flax module, under the patches above) and chain, all in one jit compiled
without excess precision, against the port's autograd from the same
input and cotangent. Each cotangent (input, weight, bias, LayerNorm scale
and offset, each operand of a chain, trans_coeff) is held apart, to
BWD_RULES: an unequal share and a largest difference in ulps of its
precision. The configs: runs/msn/GTA/gta_so3, runs/msn/otherPEs/srt,
runs/msn/GTA/gta_t2 and runs/msn/GTA/gta_so3_euclid shrunk as
tests/test_torch_bf16._shrink shrinks them, runs/msn/GTA/gta shrunk so
with `emb: camera_planar` in encoder and decoder (no published config
reaches it), and dit_gta as tests/test_torch_dit._tiny_raw with labels
[1, 3, 1]; every parameter drawn nonzero from a numpy seed (LayerNorm
scales about 1), so no bias or affine is trivial.

Bounds, each beside its largest clean measurement over the six configs
(`python -m tests.test_torch_bf16_layers` on the CPU, torch 2.13, jax
0.9.0). Forward (SHARE): Linear 2e-3 (measured 1.95e-4: one element of
5,120), Conv2d 2e-3 (1.95e-4), LayerNorm 2e-3 (6.5e-5), Embedding 0 (0),
the bf16 chains 2e-3 (GELU 3.2e-4, the eager GTA chain 4.9e-4; SiLU, the
modulations, the gated residuals and camera_planar's adds 0), the fp32
pixels 0.05 (8.3e-3: two of 240 elements, one fp32 ulp, the two sigmoids'
own rounding); camera_planar's lin_camera 5e-3 (CAMERA_POSE_SHARE,
measured 2.6e-3: 5 of 1,920 elements; its K = 12 products of the
canonical first view's pose sit within fp32 rounding of bf16 ties, and
each side differs from the fp64 product's rounding in 4-5 of them). The
largest clean difference is one ulp (Linear, Conv2d). Backward
(BWD_RULES, one ulp unless named): Linear dx 2e-3 (2.3e-4), dweight 2e-3
(2.4e-4), dbias 2e-3 (0); Conv2d dx 2e-3 (1.5e-4), dweight 2e-3 (4.3e-4),
dbias 2e-3 (0); LayerNorm dx 2e-3 (1.5e-4), dweight every element and
32 fp32 ulps (9.4e-1, 16 ulps), dbias 2e-2 (7.8e-3: one of 128, one fp32
ulp); the label table 0 (0); the pixels 2e-3 (0); the chains 2e-3 (GELU
1.8e-4; SiLU, the modulations, the gated residuals, camera_planar's adds
0), the eager GTA chain 1.5e-2 (7.6e-3). Planted, the faults make 9.1 %
(op by op, a gated residual) to 100 % of an output's elements unequal,
and 8.8 % to 100 % of a cotangent's.

Planted faults (`test_a_planted_fault_fails_its_layer`; a backward fault's
case is named backward_<fault>): each fault alone in each layer, chain or
cotangent must fail that one's check, N of N:
  * one_ulp_away: the output or cotangent moved one ulp (of its precision)
    away from zero (not planted in LayerNorm's scale cotangent, whose fp32
    sums the frameworks order differently by more);
  * rounding_skipped: the output or cotangent left in fp32 before its last
    rounding (not planted in the pixels' output, which ends in fp32, nor
    where no rounding ends the cotangent);
  * op_by_op: a chain, or its VJP, rounded to bf16 after each of its
    operations, as XLA on the CPU rounds it (chains only; a cotangent that
    is one operation has none);
  * summed_in_bf16 (backward): a cotangent that sums over broadcast axes
    accumulated in bf16 (biases, LayerNorm affines, the modulation's shift
    and scale, the gates, camera_planar's embeddings).
A planted fault that leaves the value unchanged is not counted.
The card side of these checks, at full width: chip_smoke.py's
bf16_layer_phase."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

import gta_tpu.models.encoder as j_encoder
import gta_tpu.models.layers as j_layers
import gta_tpu.ops.gta as j_gta
from gta_tpu.config import load_config as j_load_config
from gta_tpu.models import dit as j_dit
from gta_tpu.train.dit_trainer import DiTTrainer as JDiTTrainer, dit_config_from_dict as j_dit_config_from_dict
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch.config import load_config
from gta_tpu_torch.models import decoder as t_decoder, dit as t_dit, encoder as t_encoder, layers
from gta_tpu_torch.models.context import AttnContext
from gta_tpu_torch.ops.attention import euclid_attention
from gta_tpu_torch.ops.flash_core import merge_heads, split_heads
from gta_tpu_torch.ops.gta import gta_attention
from gta_tpu_torch.ops.reps import GeomReps
from gta_tpu_torch.train.dit_trainer import DiTTrainer, dit_config_from_dict
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import flax_path_to_torch_key, params_from_jax
from tests.test_torch_bf16 import FAULTS as MODEL_FAULTS, MSN_SO3, MSN_SRT, MSN_T2, _items, _jbatch, \
    _jit_rounding_each_op, _shrink, _tpu_numerics
from tests.test_torch_dit import _batch, _dit_numerics, _random_params, _round_once, _tiny_raw

BF = torch.bfloat16
MSN_EUCLID = "runs/msn/GTA/gta_so3_euclid/config.yaml"
MSN_GTA = "runs/msn/GTA/gta/config.yaml"
CONFIGS = {"msn_so3": MSN_SO3, "msn_srt": MSN_SRT, "msn_t2": MSN_T2, "msn_euclid": MSN_EUCLID,
           "msn_camera_planar": MSN_GTA, "dit_gta": None}
SHARE = {"Linear": 2e-3, "Conv2d": 2e-3, "LayerNorm": 2e-3, "Embedding": 0.0, "pixels": 0.05, "chain": 2e-3}
CAMERA_POSE_SHARE = 5e-3  # camera_planar's lin_camera (K = 12): products of the canonical view's pose sit on bf16 ties
LAYERS = ("Linear", "Conv2d", "LayerNorm", "Embedding")
LEAVES = {"Dense": "kernel", "Conv": "kernel", "LayerNorm": "scale", "Embed": "embedding"}  # a flax param per module
# the backward: each cotangent's (unequal share, ulps of its precision) by
# "<kind> <cotangent>" (a chain's kind is "chain")
BWD_RULES = {"Linear dx": (2e-3, 1), "Linear dweight": (2e-3, 1), "Linear dbias": (2e-3, 1), "Conv2d dx": (2e-3, 1),
             "Conv2d dweight": (2e-3, 1), "Conv2d dbias": (2e-3, 1), "LayerNorm dx": (2e-3, 1),
             "LayerNorm dweight": (1.0, 32), "LayerNorm dbias": (2e-2, 1), "Embedding dweight": (0.0, 0),
             "pixels dx": (2e-3, 1), "chain": (2e-3, 1), "gta_euclid": (1.5e-2, 1)}
SEED_CT = 11  # the cotangents' numpy seed


@dataclasses.dataclass
class Check:
    """One layer or chain: the port's function of JAX's operands `args`,
    JAX's output `want`; `unrounded`, the port's value before its last
    rounding from fp32 copies of the operands and of the parameters `p`
    (the bf16 values of those the layer casts), None where it ends in fp32;
    `op_by_op`, a chain rounded after each operation (None for a layer).

    The backward: `jax_fn(p, *operands)`, JAX's function (a flax module's
    apply, a chain's JAX expression) of its flax params `jax_params` (at the
    module's flax path `jax_path`) and of the args named in `operands` (None
    for an argument without a cotangent: integer labels); `params`, the
    port parameters by name whose cotangents are held; `cast`, the names of
    those the layer casts to bf16 (their cotangents carry bf16's
    precision); `sums`, per cotangent that sums over broadcast axes the
    fp32 per-element terms [n, ...] of the sum, from the output's
    cotangent; `bwd_unrounded`, the function whose fp32 cotangents are the
    unrounded ones where it is not `unrounded`; `round_params` False: the
    unrounded value takes the fp32 parameters themselves (the label table,
    whose cast is the rounding skipped)."""

    name: str
    kind: str
    port: object
    args: tuple
    want: torch.Tensor
    unrounded: object = None
    op_by_op: object = None
    jax_fn: object = None
    jax_params: object = None
    jax_path: tuple = ()
    operands: tuple = ("x",)
    params: dict = dataclasses.field(default_factory=dict)
    cast: tuple = ()
    sums: dict = dataclasses.field(default_factory=dict)
    bwd_unrounded: object = None
    round_params: bool = True
    share: float = None
    fault_grads: dict = dataclasses.field(default_factory=dict, repr=False)  # _fault_grads' results

    def share_and_ulps(self, got):
        """(share of unequal elements, the largest difference in ulps of the
        output dtype at the larger of JAX's element and the tensor's RMS)."""
        return _gap(got, self.want, 7 if self.want.dtype == BF else 23)

    def holds(self, got) -> bool:
        share, ulps = self.share_and_ulps(got)
        most = SHARE.get(self.kind, SHARE["chain"]) if self.share is None else self.share
        return got.dtype == self.want.dtype and share <= most and ulps <= 1.0

    def unrounded_params(self):
        rounded = self.cast if self.round_params else ()
        return {n: p.detach().to(BF).float() if n in rounded else p.detach() for n, p in self.params.items()}


@dataclasses.dataclass
class Cot:
    """One cotangent of a Check: the port's (`got`, from autograd) and
    JAX's (`want`, from its VJP) for the same input and output cotangent
    `ct`; `bits`, the mantissa bits of its precision (bf16's 7 for a cast
    parameter's, whose cotangent is compared in fp32 after the cast)."""

    check: Check
    name: str
    ct: torch.Tensor
    got: torch.Tensor
    want: torch.Tensor
    bits: int

    @property
    def kind(self):
        """The rule's key: "<layer kind> <cotangent>", "pixels dx", or the
        chain's kind."""
        kind = self.check.kind
        return f"{kind} {self.name}" if kind in LAYERS or kind == "pixels" else kind

    @property
    def label(self):
        return f"{self.check.name} {self.name}"

    def share_and_ulps(self, got):
        return _gap(got, self.want, self.bits)

    def holds(self, got) -> bool:
        share, ulps = self.share_and_ulps(got)
        most, most_ulps = BWD_RULES.get(self.kind, BWD_RULES["chain"])
        return got.dtype == self.want.dtype and share <= most and ulps <= most_ulps


def _gap(got, want, bits):
    """(share of unequal elements, the largest difference in ulps of a
    `bits`-bit mantissa at the larger of want's element and its RMS)."""
    want = want.double()
    mag = torch.maximum(want.abs(), want.square().mean().sqrt())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    diff = (got.double() - want).abs()
    return (got.double() != want).double().mean().item(), (diff / ulp).max().item()


def _torch(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(BF)
    return torch.from_numpy(x.copy())


def _to_jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16) if t.dtype == BF else jnp.asarray(t.numpy())


class _F32Dense(nn.Dense):
    """A flax Dense whose output leaves in fp32 (its bf16 values), so that
    the chain it feeds computes in fp32; the capture records flax's Dense
    call inside it."""

    def __call__(self, x):
        return super().__call__(x).astype(jnp.float32)


class _TPUTransformer(j_layers.Transformer):
    """gta_tpu/models/layers.Transformer rounding its input to its dtype
    once: the end of the chain before it."""

    def __call__(self, x, *args, **kwargs):
        return super().__call__(x.astype(self.dtype), *args, **kwargs)


def _nvs_numerics(mp: pytest.MonkeyPatch):
    """tests/test_torch_bf16._tpu_numerics, and the sliced GTA transforms'
    operands promoted once (gta_tpu/models/layers.py _gta -> gta_attention,
    msn gta_so3_euclid's eager route): the chain computes in its fp32 tables
    anyway, where XLA on the CPU converts q, k, v and trans_coeff at each
    use and adds the rounded cotangents in bf16."""
    _tpu_numerics(mp)
    attention = j_layers.gta_attention

    def promoted_once(q, k, v, attn_fn, reps, args, trans_coeff=None):
        if not j_gta._blockdiag_ok(reps, args):
            f32 = jnp.float32
            q, k = q.astype(f32), k.astype(f32)
            v = v.astype(f32) if args.v_transform else v
            trans_coeff = None if trans_coeff is None else trans_coeff.astype(f32)
        return attention(q, k, v, attn_fn, reps, args, trans_coeff)

    mp.setattr(j_layers, "gta_attention", promoted_once)


def _camera_planar_numerics(mp: pytest.MonkeyPatch):
    """_nvs_numerics and camera_planar's two adds after the stem
    (gta_tpu/models/encoder.py:177) as one fused chain: the two Dense
    outputs enter it in fp32 and the encoder's Transformer rounds the sum
    once."""
    _nvs_numerics(mp)
    dense = lambda *a, name=None, **kw: (  # noqa: E731
        _F32Dense if name in ("lin_planar", "lin_camera") else nn.Dense)(*a, name=name, **kw)
    mp.setattr(j_encoder, "nn", types.SimpleNamespace(**{**vars(nn), "Dense": dense}))
    mp.setattr(j_encoder, "Transformer", _TPUTransformer)


def _capture(apply, *args):
    """apply(*args) under jit, every bf16 operation rounded, with each flax
    module call's array inputs and output (the first, for a tuple)
    captured: ({module path: (inputs, output)} as torch tensors, {module
    path: flax class name}, {module path: an unbound copy of the module},
    {attention path: its GeomReps as torch tensors})."""
    types_, modules = {}, {}

    def run(*args):
        calls, geoms = {}, {}

        def record(next_fun, a, kw, ctx):
            out = next_fun(*a, **kw)
            if ctx.method_name == "__call__":
                path = "/".join(ctx.module.path)
                if isinstance(ctx.module, (_F32Dense, _TPUTransformer)) and path in calls:
                    return out  # a test subclass: flax's call inside it was recorded
                assert path not in calls, path  # one call per module
                m = ctx.module
                if isinstance(m, _F32Dense):  # as the flax Dense it is inside
                    m = nn.Dense(m.features, use_bias=m.use_bias, dtype=m.dtype)
                types_[path] = type(m).__name__
                modules[path] = m.clone(parent=None)
                calls[path] = (tuple(x for x in a if isinstance(x, jax.Array)), out[0] if isinstance(out, tuple) else out)
                context = [x for x in (*a, *kw.values()) if hasattr(x, "geom")]
                if types_[path] == "Attention" and context:
                    geoms[path] = context[0].geom
            return out

        with nn.intercept_methods(record):
            apply(*args)
        return calls, geoms

    calls, geoms = _jit_rounding_each_op(run, *args)  # a consumer takes the rounded value captured
    calls = {p: (tuple(_torch(x) for x in a), _torch(o)) for p, (a, o) in calls.items()}
    geoms = {p: jax.tree.map(_torch, g) for p, g in geoms.items()}
    return calls, types_, modules, geoms


def _nonzero_params(shapes, seed):
    """tests/test_torch_dit._random_params (kernels N(0, 1/fan_in), biases
    N(0, 0.1^2)), with LayerNorm scales 1 + N(0, 0.1^2)."""
    params = _random_params(shapes, seed)
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(1 + 0.1 * rng.randn(*x.shape), jnp.float32) if p[-1].key == "scale" else x, params)


@jax.custom_vjp
def _add_bias(y, bias):
    """y + bias over y's last axis, in y's dtype (flax Dense / Conv), with
    the bias's cotangent summed in fp32 and rounded once."""
    return y + bias


def _add_bias_fwd(y, bias):
    return y + bias, None


def _add_bias_bwd(_, ct):
    return ct, jnp.sum(ct.astype(jnp.float32), tuple(range(ct.ndim - 1))).astype(ct.dtype)


_add_bias.defvjp(_add_bias_fwd, _add_bias_bwd)


def _jax_layer(module, kind):
    """JAX's function (params, x) of a captured flax Dense / Conv /
    LayerNorm, its VJP under the convention: a Dense's or Conv's bias
    added by `_add_bias` (XLA on the CPU sums its bf16 cotangent in bf16),
    a LayerNorm's bf16 input promoted once (flax promotes it for the
    statistics and again for the normalisation, and XLA on the CPU adds the
    two rounded cotangents in bf16). The forward is flax's, bit for bit."""
    if kind == "LayerNorm":
        return lambda p, x: module.apply({"params": p}, x.astype(jnp.float32))
    if not module.use_bias:
        return lambda p, x: module.apply({"params": p}, x)
    bare = module.clone(use_bias=False)
    return lambda p, x: _add_bias(bare.apply({"params": {"kernel": p["kernel"]}}, x), p["bias"].astype(module.dtype))


def _subtree(params, path):
    """The params at a flax path ({} for a module without any)."""
    for p in path:
        params = params.get(p, {})
    return params


# ---------------------------------------------------------------------------
# The layers and chains of one config
# ---------------------------------------------------------------------------


def _fp32(fn):
    """The port's chain on fp32 copies of its operands: its value unrounded."""
    return lambda *a: fn(*(x.float() for x in a))


# the chains op by op: over bf16 operands each torch operation rounds its
# result to bf16, as XLA on the CPU does
GELU_ERF_OPS = lambda x: 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))  # noqa: E731
GELU_TANH_OPS = lambda x: 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))  # noqa: E731
SILU_OPS = lambda x: x * torch.sigmoid(x)  # noqa: E731
MODULATE_OPS = lambda x, shift, scale: x * (1.0 + scale[:, None]) + shift[:, None]  # noqa: E731
GATED_OPS = lambda x, gate, h: x + gate[:, None] * h  # noqa: E731


def _over_items(x):
    """A [B, T, C] tensor's per-item sum terms: [T, B, C] in fp32."""
    return x.float().transpose(0, 1)


def _layer_checks(model, calls, types_, modules, params):
    """A Check per captured flax Dense / Conv / LayerNorm / Embed: the port
    module of the same name on JAX's input."""
    checks = []
    for path, (args, want) in calls.items():
        leaf = LEAVES.get(types_[path])
        if leaf is None:
            continue
        fpath = tuple(path.split("/"))
        name = flax_path_to_torch_key(fpath + (leaf,)).rsplit(".", 1)[0]
        mod = model.get_submodule(name)
        jmod = modules[path]
        x = args[0]
        common = dict(jax_params=_subtree(params, fpath), jax_path=fpath,
                      params={n: p for n, p in mod.named_parameters()})
        casts_x = ("x",) if x.dtype == torch.float32 and not isinstance(mod, layers.LayerNorm) else ()
        if isinstance(mod, torch.nn.Embedding):  # the table's cast is its owner's (models/dit.LabelEmbedder)
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            checks.append(Check(name, "Embedding", lambda y, o=owner: o(y.long()), (x,), want,
                                lambda y, weight: F.embedding(y.long(), weight),
                                jax_fn=lambda p, y=_to_jax(x), m=jmod: m.apply({"params": p}, y), operands=(None,),
                                cast=("weight",), round_params=False, **common))
            continue
        jax_fn = _jax_layer(jmod, types_[path])
        if isinstance(mod, layers.Conv2d):
            def nhwc(f):
                return lambda x, **p: f(x.permute(0, 3, 1, 2), **p).permute(0, 2, 3, 1)

            def exact(x, weight, bias=None, m=mod):
                return F.conv2d(x, weight, bias, m.stride, m.padding)

            sums = {"dbias": lambda ct: ct.float().reshape(-1, ct.shape[-1])} if mod.bias is not None else {}
            checks.append(Check(name, "Conv2d", nhwc(mod), (x,), want, nhwc(_fp32_args(exact)), jax_fn=jax_fn,
                                cast=("weight", "bias") + casts_x, sums=sums, **common))
        elif isinstance(mod, layers.Linear):
            sums = {"dbias": lambda ct: ct.float().reshape(-1, ct.shape[-1])} if mod.bias is not None else {}
            checks.append(Check(name, "Linear", mod, (x,), want, _fp32_args(F.linear), jax_fn=jax_fn,
                                cast=("weight", "bias") + casts_x, sums=sums,
                                share=CAMERA_POSE_SHARE if name.endswith("lin_camera") else None, **common))
        else:
            assert isinstance(mod, layers.LayerNorm), name

            def norm(x, weight=None, bias=None, m=mod):
                return F.layer_norm(x, m.normalized_shape, weight, bias, m.eps)

            def xhat(x, m=mod):
                return F.layer_norm(x.float(), m.normalized_shape, None, None, m.eps)

            sums = {"dweight": lambda ct, x=x, xhat=xhat: (ct.float() * xhat(x)).reshape(-1, ct.shape[-1]),
                    "dbias": lambda ct: ct.float().reshape(-1, ct.shape[-1])} if mod.elementwise_affine else {}
            checks.append(Check(name, "LayerNorm", mod, (x,), want, _fp32_args(norm), jax_fn=jax_fn, sums=sums,
                                **common))
    return checks


def _fp32_args(fn):
    """fn on fp32 copies of its tensor operands (parameters come in fp32)."""
    return lambda *a, **p: fn(*(x.float() for x in a), **p)


def _euclid_chain(model, path, calls, modules, geoms, params):
    """msn gta_so3_euclid's eager GTA attention (gta_tpu/models/layers.py
    _gta -> gta_tpu/ops/gta.py gta_attention with euclid_attention): the
    transforms, the attention and the inverse transform, from the bf16 q, k,
    v of the projections to to_out's input, which to_out rounds to bf16.
    The chain's tables promote it to fp32 (the geometry is fp32), so it
    computes in fp32 on both sides and rounds once; op by op, as if every
    product of the chain were bf16, is its fault."""
    fpath = tuple(path.split("/"))
    layer = model.get_submodule(flax_path_to_torch_key(fpath + ("trans_coeff",)).rsplit(".", 1)[0])
    jmod = modules[path]
    heads, gta = layer.heads, layer.attn.gta
    if f"{path}/to_qkv" in calls:
        q, k, v = calls[f"{path}/to_qkv"][1].chunk(3, -1)
    else:
        q, (k, v) = calls[f"{path}/to_q"][1], calls[f"{path}/to_kv"][1].chunk(2, -1)
    geom = GeomReps(**{f.name: getattr(geoms[path], f.name) for f in dataclasses.fields(GeomReps)})
    ctx = AttnContext(geom=geom)
    as_bf16 = GeomReps(**{f.name: jax.tree.map(lambda t: t.to(BF), getattr(geom, f.name))
                          for f in dataclasses.fields(GeomReps)})
    ctx_bf16 = AttnContext(geom=as_bf16)

    def port(q, k, v, c=ctx):
        out, _ = layer._eager(*(split_heads(t, heads) for t in (q, k, v)), c, layer._tau())
        return merge_heads(out).to(BF)  # to_out's cast

    def unrounded(q, k, v, trans_coeff):
        attend = functools.partial(euclid_attention, scale=layer.scale, tau=1.0)
        out, _ = gta_attention(*(split_heads(t.float(), heads) for t in (q, k, v)), attend, geom, gta, trans_coeff)
        return merge_heads(out)

    jgeom = jax.tree.map(_to_jax, geoms[path])

    def jax_fn(p, q, k, v):
        attend = functools.partial(j_layers.euclid_attention, scale=jmod.dim_head ** -0.5, tau=1.0)
        qh, kh, vh = (j_layers._split_heads(t, jmod.heads) for t in (q, k, v))
        out, _ = j_layers.gta_attention(qh, kh, vh, attend, jgeom, jmod.attn.gta, p["trans_coeff"].astype(jmod.dtype))
        return j_layers._merge_heads(out).astype(jmod.dtype)

    name = flax_path_to_torch_key(fpath + ("trans_coeff",)).rsplit(".", 1)[0]
    return Check(f"{name} (eager GTA, euclid)", "gta_euclid", port, (q, k, v), calls[f"{path}/to_out"][0][0].to(BF),
                 unrounded, lambda q, k, v: port(q, k, v, ctx_bf16), jax_fn=jax_fn,
                 jax_params={"trans_coeff": _subtree(params, fpath)["trans_coeff"]}, jax_path=fpath,
                 operands=("q", "k", "v"), params={"trans_coeff": layer.trans_coeff}, cast=("trans_coeff",))


def _camera_planar_chain(model, calls):
    """camera_planar's two adds after the stem (gta_tpu/models/encoder.py:
    177, the port's models/encoder.embed_camera_planar): the patches' x
    [B*N, Ha, Wa, C] plus the grid embedding [Ha, Wa, C] and each view's
    camera embedding [B*N, C], to the Transformer's input [B, N*Ha*Wa, C]."""
    x, planar, camera = calls["encoder/per_patch_linear"][1], calls["encoder/lin_planar"][1], \
        calls["encoder/lin_camera"][1]
    want = calls["encoder/transformer"][0][0].to(BF)
    BN, Ha, Wa, C = x.shape
    B = want.shape[0]

    def shaped(fn):
        return lambda x, planar, camera: fn(x.reshape(B, BN // B, Ha * Wa, C), planar.reshape(1, 1, Ha * Wa, C),
                                            camera.reshape(B, BN // B, 1, C)).reshape(B, -1, C)

    def jax_fn(p, x, planar, camera):
        f32 = jnp.float32
        y = x.astype(f32) + planar.astype(f32)[None] + camera.astype(f32)[:, None, None, :]
        return y.astype(x.dtype).reshape(B, -1, C)

    return Check("encoder camera_planar adds", "camera_planar", shaped(t_encoder.embed_camera_planar),
                 (x, planar, camera), want, shaped(lambda x, p, c: x.float() + p.float() + c.float()),
                 shaped(lambda x, p, c: x + p + c), jax_fn=jax_fn, jax_params={}, operands=("x", "planar", "camera"),
                 sums={"dplanar": lambda ct: ct.float().reshape(BN, Ha, Wa, C),
                       "dcamera": lambda ct: ct.float().reshape(BN, Ha * Wa, C).transpose(0, 1)})


def _nvs_chains(model, calls, types_, modules, geoms, params):
    """The NVS configs' chains: each FeedForward's erf GELU, the pixels;
    msn gta_so3_euclid's eager GTA attention, camera_planar's adds."""
    checks = []
    for path in calls:
        if path.split("/")[-1].startswith("ff_"):
            up, down = calls[path + "/Dense_0"], calls[path + "/Dense_1"]
            name = flax_path_to_torch_key(tuple(path.split("/")) + ("Dense_0", "kernel")).replace("net.0.weight", "net.1")
            act = model.get_submodule(name)
            checks.append(Check(name + " (GELU, erf)", "gelu", act, (up[1],), down[0][0], _fp32(act), GELU_ERF_OPS,
                                jax_fn=lambda p, x: nn.gelu(x, approximate=False), jax_params={}))
        elif types_[path] == "Attention" and modules[path].attn.method == "gta" and modules[path].attn.gta.euclid_sim:
            checks.append(_euclid_chain(model, path, calls, modules, geoms, params))
    if "encoder/lin_planar" in calls:
        checks.append(_camera_planar_chain(model, calls))
    h = calls["decoder/render_mlp_out"][1]
    checks.append(Check("decoder pixels (sigmoid, fp32)", "pixels", t_decoder.render_pixels, (h,), calls["decoder"][1],
                        None, lambda h: torch.sigmoid(h).float(),
                        jax_fn=lambda p, h: nn.sigmoid(h).astype(jnp.float32), jax_params={},
                        bwd_unrounded=_fp32(t_decoder.render_pixels)))
    return checks


def _dit_chains(model, calls, *_):
    """dit_gta's chains: the timestep MLP's SiLU; in each block SiLU(c), the
    two modulations, the gated residuals and the tanh GELU; the final
    layer's SiLU(c) and modulation."""
    def gelu_tanh(h):
        return F.gelu(h, approximate="tanh")

    def modulate_sums(x, shift, scale):
        return {"dshift": _over_items, "dscale": lambda ct, x=x: _over_items(ct.float() * x.float())}

    def gated_sums(x, gate, h):
        return {"dgate": lambda ct, h=h: _over_items(ct.float() * h.float())}

    silu = ("silu", F.silu, SILU_OPS, ("x",), lambda p, x: nn.silu(x), None)
    gelu = ("gelu", gelu_tanh, GELU_TANH_OPS, ("x",), lambda p, x: nn.gelu(x, approximate=True), None)
    modulate = ("modulate", t_dit._modulate, MODULATE_OPS, ("x", "shift", "scale"),
                lambda p, *a: j_dit._modulate(*a), modulate_sums)
    gated = ("gated", t_dit._gated, GATED_OPS, ("x", "gate", "h"),
             lambda p, *a: _round_once(lambda x, gate, h: x + gate[:, None] * h)(*a), gated_sums)

    def check(name, chain, args, want):
        kind, port, ops, operands, jax_fn, sums = chain
        return Check(f"{name} ({kind})", kind, port, args, want, _fp32(port), ops, jax_fn=jax_fn, jax_params={},
                     operands=operands, sums=sums(*args) if sums else {})

    def out(p):
        return calls[p][1]

    def inp(p, i=0):
        return calls[p][0][i]

    checks = [check("t_embed", silu, (out("t_embed/fc1"),), inp("t_embed/fc2"))]
    c = inp("block_0", 1)
    blocks = sorted(p for p in calls if p.count("/") == 0 and p.startswith("block_"))
    for b in blocks:
        s1, g1, gate1, s2, g2, gate2 = out(f"{b}/ada_mod").chunk(6, -1)
        checks += [
            check(f"{b}.ada_mod input", silu, (inp(b, 1),), inp(f"{b}/ada_mod")),
            check(f"{b} attention input", modulate, (out(f"{b}/norm1"), s1, g1), inp(f"{b}/attn")),
            check(f"{b} attention residual", gated, (inp(b), gate1, out(f"{b}/attn")), inp(f"{b}/norm2")),
            check(f"{b}.mlp_fc1 input", modulate, (out(f"{b}/norm2"), s2, g2), inp(f"{b}/mlp_fc1")),
            check(f"{b}.mlp_fc2 input", gelu, (out(f"{b}/mlp_fc1"),), inp(f"{b}/mlp_fc2")),
            check(f"{b} MLP residual", gated, (inp(f"{b}/norm2"), gate2, out(f"{b}/mlp_fc2")), out(b)),
        ]
    shift, scale = out("final_mod").chunk(2, -1)
    checks += [check("final_mod input", silu, (c,), inp("final_mod")),
               check("final_proj input", modulate, (out("final_norm"), shift, scale), inp("final_proj"))]
    return checks


def _with_emb(cfg, emb):
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, emb=emb), decoder=dataclasses.replace(m.decoder, emb=emb)))


def _config(name):
    """(the port's bf16 model with JAX's weights, its Checks, each Check's
    Cots) for one config."""
    if name == "dit_gta":
        raw = _tiny_raw("gta", mixed_prec=True)
        jtr = JDiTTrainer(j_dit_config_from_dict(raw))
        b = _batch()
        b["label"] = np.array([1, 3, 1], np.int32)  # a repeated label: the table's cotangent sums two rows
        args = (jnp.asarray(b["image"]), jnp.asarray(b["t"]), jnp.asarray(b["label"]))
        params = _nonzero_params(jax.eval_shape(lambda: jtr.init_state({"image": b["image"], "label": b["label"]}).params),
                                 seed=7)
        model = DiTTrainer(dit_config_from_dict(raw), device="cpu").model
        numerics, chains = _dit_numerics, _dit_chains
    else:
        path = CONFIGS[name]
        shrink = (lambda c: _with_emb(_shrink(c, True), "camera_planar")) if name == "msn_camera_planar" else \
            (lambda c: _shrink(c, True))
        jcfg = shrink(j_load_config(path))
        jtr = JTrainer(dataclasses.replace(jcfg, training=dataclasses.replace(jcfg.training, flash="fused")))
        tcfg = shrink(load_config(path))
        args = (_jbatch(_items(tcfg, (0, 1))),)
        params = _nonzero_params(jax.eval_shape(lambda: jtr.model.init(jax.random.PRNGKey(0), *args)), seed=3)
        model = Trainer(tcfg, device="cpu").model
        numerics = _camera_planar_numerics if name == "msn_camera_planar" else _nvs_numerics
        chains = _nvs_chains
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tree = params["params"]
    with pytest.MonkeyPatch.context() as patch:
        numerics(patch)
        calls, types_, modules, geoms = _capture(lambda p, *a: jtr.model.apply(p, *a, deterministic=True), params,
                                                 *args)
    checks = _layer_checks(model, calls, types_, modules, tree) + chains(model, calls, types_, modules, geoms, tree)
    return model, checks, _cotangents(checks, numerics)


# ---------------------------------------------------------------------------
# The backward: JAX's VJP and the port's autograd from one cotangent
# ---------------------------------------------------------------------------


def _autograd(fn, check, ct, fp32=False):
    """{cotangent name: tensor}: fn's cotangents for its operands and the
    check's parameters, from the output cotangent ct. fp32: fn takes fp32
    copies of the operands and the parameters (`unrounded_params`) as
    keywords; else the port's own parameters."""
    leaves = [a.detach().float() if fp32 and a.is_floating_point() else a.detach().clone() for a in check.args]
    leaves = [a.requires_grad_() if n else a for a, n in zip(leaves, check.operands)]
    params = {n: p.clone().requires_grad_() for n, p in check.unrounded_params().items()} if fp32 else check.params
    for p in check.params.values():
        p.grad = None
    with torch.enable_grad():
        out = fn(*leaves, **params) if fp32 else fn(*leaves)
        out.backward(ct.float() if fp32 else ct)
    grads = {f"d{n}": a.grad for a, n in zip(leaves, check.operands) if n}
    grads.update({f"d{n}": p.grad for n, p in params.items()})
    for p in check.params.values():
        p.grad = None
    return grads


def _cotangents(checks, numerics):
    """The Cots of every check: one output cotangent each drawn with numpy
    (seed SEED_CT) in the output's dtype, JAX's VJP of all checks in one
    jit compiled without excess precision (the config's numerics patched),
    and the port's autograd."""
    rng = np.random.RandomState(SEED_CT)
    cts = [torch.from_numpy(rng.randn(*c.want.shape).astype(np.float32)).to(c.want.dtype) for c in checks]

    def run(inputs):
        grads = []
        for c, (p, xs, ct) in zip(checks, inputs):
            _, vjp = jax.vjp(c.jax_fn, p, *xs)
            grads.append(vjp(ct))
        return grads

    inputs = [(c.jax_params, tuple(_to_jax(a) for a, n in zip(c.args, c.operands) if n), _to_jax(ct))
              for c, ct in zip(checks, cts)]
    with pytest.MonkeyPatch.context() as patch:
        numerics(patch)
        got = _jit_rounding_each_op(run, inputs)
    out = []
    for c, ct, (gp, *gx) in zip(checks, cts, got):
        want = {f"d{n}": _torch(g) for n, g in zip([n for n in c.operands if n], gx)}
        nested = jax.tree.map(np.asarray, gp)
        for key in reversed(c.jax_path):
            nested = {key: nested}
        want.update({"d" + k.rsplit(".", 1)[1]: v for k, v in params_from_jax(nested).items()} if gp else {})
        port = _autograd(c.port, c, ct)
        assert set(port) == set(want), (c.name, set(port), set(want))
        for n in port:
            bits = 7 if want[n].dtype == BF or n[1:] in c.cast else 23
            out.append(Cot(c, n, ct, port[n], want[n], bits))
    return out


def _bf16_sum(terms):
    """terms [n, ...] summed over their first axis in a bf16 accumulator."""
    acc = torch.zeros(terms.shape[1:], dtype=BF)
    for t in terms:
        acc = (acc.float() + t).to(BF)
    return acc


def _ulp_away(x, bits):
    """x moved one ulp (of a `bits`-bit mantissa) away from zero."""
    y = x.to(BF) if bits == 7 else x
    return torch.nextafter(y, torch.where(y < 0, -torch.inf, torch.inf).to(y.dtype)).to(x.dtype)


BWD_FAULTS = ("one_ulp_away", "rounding_skipped", "op_by_op", "summed_in_bf16")


def _bwd_planted(cot, fault):
    """The port's cotangent `cot` with `fault` planted, or None where it
    cannot be planted or changes nothing (a cotangent that is one operation
    has no op-by-op form; the output's own cotangent, rounded or not, is
    bf16 already)."""
    got = _bwd_fault(cot, fault)
    return None if got is None or torch.equal(got.double(), cot.got.double()) else got


def _fault_grads(check, ct, fault):
    """_autograd of the check's rounding_skipped or op_by_op form, computed
    once for all of its cotangents."""
    if fault not in check.fault_grads:
        check.fault_grads[fault] = (_autograd(check.bwd_unrounded or check.unrounded, check, ct, fp32=True)
                                    if fault == "rounding_skipped" else _autograd(check.op_by_op, check, ct))
    return check.fault_grads[fault]


def _bwd_fault(cot, fault):
    """The port's cotangent `cot` with `fault` planted, or None where it
    cannot be planted: one ulp away where the two frameworks' fp32 sums
    already differ by more (LayerNorm's scale), rounding skipped where the
    cotangent ends in no rounding (fp32 LayerNorm affines), op by op in a
    layer, a bf16 sum where it sums no broadcast axis."""
    c = cot.check
    if fault == "one_ulp_away":
        return _ulp_away(cot.got, cot.bits) if BWD_RULES.get(cot.kind, BWD_RULES["chain"])[1] <= 1 else None
    if fault == "rounding_skipped":
        return _fault_grads(c, cot.ct, fault)[cot.name] if cot.bits == 7 and (c.bwd_unrounded or c.unrounded) else None
    if fault == "op_by_op":
        return _fault_grads(c, cot.ct, fault)[cot.name] if c.op_by_op else None
    terms = c.sums.get(cot.name)
    return None if terms is None else _bf16_sum(terms(cot.ct)).reshape(cot.got.shape).to(cot.got.dtype)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: intra-op threads only contend with the parallel test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request):
    torch.manual_seed(0)
    return request.param, *_config(request.param)


def _run(check, fault=None):
    """The port's output of `check` on JAX's operands, with `fault` planted."""
    with torch.no_grad():
        if fault == "rounding_skipped":
            return check.unrounded(*check.args, **check.unrounded_params())
        if fault == "op_by_op":
            return check.op_by_op(*check.args)
        got = check.port(*check.args)
        return _ulp_away(got, 7 if got.dtype == BF else 23) if fault == "one_ulp_away" else got


FAULTS = (*MODEL_FAULTS, "op_by_op")  # the model-level checks' faults, and a chain rounded op by op
CHAIN_KINDS = {"msn_euclid": {"gelu", "pixels", "gta_euclid"}, "msn_camera_planar": {"gelu", "pixels", "camera_planar"},
               "dit_gta": {"silu", "modulate", "gated", "gelu"}}


def _planted(checks, fault):
    """The checks `fault` can be planted in."""
    return [c for c in checks if {"rounding_skipped": c.unrounded, "op_by_op": c.op_by_op}.get(fault, True)]


def test_every_bf16_layer_and_chain_matches_jax(config):
    name, model, checks, _ = config
    failed = [(c.name, c.share_and_ulps(got), got.dtype) for c in checks if not c.holds(got := _run(c))]
    assert not failed, failed
    # every bf16 layer of the port is checked, and every chain kind of the config
    kinds = (layers.Linear, layers.Conv2d, layers.LayerNorm, torch.nn.Embedding)
    every = {n for n, m in model.named_modules() if isinstance(m, kinds)}
    assert every == {c.name for c in checks if c.kind in LAYERS}, every ^ {c.name for c in checks}
    assert {c.kind for c in checks if c.kind not in LAYERS} == CHAIN_KINDS.get(name, {"gelu", "pixels"})


@pytest.mark.parametrize("fault", (*FAULTS, *(f"backward_{f}" for f in BWD_FAULTS)))
def test_a_planted_fault_fails_its_layer(config, fault):
    """`fault` planted in each layer or chain alone fails that one's check,
    and a backward fault planted in each cotangent alone fails that
    cotangent's: N of N."""
    name, _, checks, cots = config
    if fault.startswith("backward_"):
        fault = fault[len("backward_"):]
        planted = [(c, got) for c in cots if (got := _bwd_planted(c, fault)) is not None]
        missed = [c.label for c, got in planted if c.holds(got)]
        print(f"{name} backward {fault}: caught in {len(planted) - len(missed)} of {len(planted)}")
    else:
        planted = _planted(checks, fault)
        missed = [c.name for c in planted if c.holds(_run(c, fault))]
        print(f"{name} {fault}: caught in {len(planted) - len(missed)} of {len(planted)}")
    assert planted and not missed, missed


def test_every_bf16_cotangent_matches_jax(config):
    """Each layer's and chain's cotangents (input, weight, bias, LayerNorm
    affine, each operand of a chain) from the port's autograd against JAX's
    VJP from the same input and output cotangent."""
    name, _, checks, cots = config
    failed = [(c.label, c.share_and_ulps(c.got), c.got.dtype) for c in cots if not c.holds(c.got)]
    assert not failed, failed
    assert {c.check.name for c in cots} == {c.name for c in checks if c.operands != (None,) or c.params}


# ---------------------------------------------------------------------------
# The chains off the six configs, as functions against the JAX expression
# ---------------------------------------------------------------------------


def _bf16_operands(rng, *shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(BF) for s in shapes]


def _jax(*xs):
    return [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in xs]


def test_mln_film_rounds_once(rng):
    """models/layers.film against mln's FiLM (gta_tpu/models/layers.py:282)
    under the convention, on bf16 operands: the same bits, and the op-by-op
    chain (JAX on the CPU) differs."""
    g, x, b = _bf16_operands(rng, (4, 256, 384), (4, 256, 384), (4, 256, 384))
    jg, jx, jb = _jax(g, x, b)
    want = _torch((jg.astype(jnp.float32) * jx.astype(jnp.float32) + jb.astype(jnp.float32)).astype(jnp.bfloat16))
    got = layers.film(g, x, b)
    check = Check("film", "chain", layers.film, (g, x, b), want)
    assert check.holds(got) and torch.equal(got, want)
    assert not check.holds(_torch(jg * jx + jb))


def test_repast_scores_end_in_fp32(rng):
    """repast's attention weights (models/layers.Attention._repast) from bf16
    q, k and a bf16 tau, against JAX's `softmax((sim * scale / tau)
    .astype(float32))` under the convention (the product rounded to bf16,
    the chain in fp32): within fp32's rounding, where rounding the scores
    to bf16 first (JAX on the CPU) moves them by bf16's."""
    from gta_tpu_torch.config import AttnConfig
    from gta_tpu_torch.models.context import AttnContext

    layer = layers.Attention(64, heads=2, dim_head=32, attn=AttnConfig(method="repast", softmax="adjustable", q_emb_dim=180,
                                                                   k_emb_dim=180, enable_scale=True))
    layer = layers.set_compute_dtype(layer, BF)
    with torch.no_grad():
        layer.attend.tau.fill_(0.7)
    B, T, Nk, L = 2, 6, 3, 4
    x, z = _bf16_operands(rng, (B, T, 64), (B, Nk * L, 64))
    ctx = AttnContext(query_ray_emb=torch.from_numpy(rng.randn(B, T, Nk, 180).astype(np.float32)),
                      key_ray_emb=torch.from_numpy(rng.randn(B, Nk, L, 180).astype(np.float32)))
    with torch.no_grad():
        _, attn = layer(x, z, ctx, return_attmap=True)
        q = layer.to_q(torch.cat([x[:, :, None].expand(B, T, Nk, 64), ctx.query_ray_emb.to(BF)], -1))
        k = layer.to_k(torch.cat([z.reshape(B, Nk, L, 64), ctx.key_ray_emb.to(BF)], -1))
    jq, jk = (jnp.asarray(t.float().numpy(), jnp.bfloat16).reshape(*t.shape[:-1], 2, 32) for t in (q, k))
    jq, jk = jnp.moveaxis(jq, -2, 1), jnp.moveaxis(jk, -2, 1)
    sim = jnp.einsum("bhtnc,bhnlc->bhtnl", jq, jk).reshape(B, 2, T, -1)  # bf16, as flax rounds a product
    tau = jnp.asarray(0.7, jnp.bfloat16)
    want = jax.nn.softmax((sim.astype(jnp.float32) * 32**-0.5 / tau), -1).astype(jnp.bfloat16)
    op_by_op = jax.nn.softmax((sim * 32**-0.5 / tau).astype(jnp.float32), -1).astype(jnp.bfloat16)
    check = Check("repast weights", "chain", None, (), _torch(want))
    assert check.holds(attn), check.share_and_ulps(attn)
    assert not check.holds(_torch(op_by_op)), check.share_and_ulps(_torch(op_by_op))


# ---------------------------------------------------------------------------
# The measurements the bounds above come from (a probe, not a test)
# ---------------------------------------------------------------------------


def _measure():
    """Print each layer's and chain's clean unequal share and largest ulp,
    forward and per cotangent, the largest per kind, and each fault's
    catches, for the six configs. From the repository root (CPU, ~2 min):
    JAX_PLATFORMS=cpu python -m tests.test_torch_bf16_layers"""
    torch.set_num_threads(1)  # as the tests run
    worst, worst_bwd = {}, {}
    for name in CONFIGS:
        torch.manual_seed(0)
        _, checks, cots = _config(name)
        for c in checks:
            share, ulps = c.share_and_ulps(_run(c))
            kind = (c.kind if c.share is None else "Linear (camera pose)") if c.kind in LAYERS else "chain " + c.kind
            worst[kind] = tuple(map(max, worst.get(kind, (0, 0)), (share, ulps)))
            print(f"{name} {c.name}: {c.want.numel()} elements, unequal {share:.2e}, largest {ulps:.2f} ulp", flush=True)
        for c in cots:
            share, ulps = c.share_and_ulps(c.got)
            worst_bwd[c.kind] = tuple(map(max, worst_bwd.get(c.kind, (0, 0)), (share, ulps)))
            print(f"{name} {c.label}: {c.want.numel()} elements, unequal {share:.2e}, largest {ulps:.2f} ulp "
                  f"of {'bf16' if c.bits == 7 else 'fp32'}", flush=True)
        for fault in FAULTS:
            planted = _planted(checks, fault)
            shares = [c.share_and_ulps(_run(c, fault))[0] for c in planted]
            print(f"{name} {fault}: caught in {sum(not c.holds(_run(c, fault)) for c in planted)} of {len(planted)}, "
                  f"unequal {min(shares):.2e}-{max(shares):.2e}")
        for fault in BWD_FAULTS:
            planted = [(c, got) for c in cots if (got := _bwd_planted(c, fault)) is not None]
            gaps = [c.share_and_ulps(got) for c, got in planted]
            print(f"{name} backward {fault}: caught in {sum(not c.holds(got) for c, got in planted)} of "
                  f"{len(planted)}, unequal {min(g[0] for g in gaps):.2e}-{max(g[0] for g in gaps):.2e}, "
                  f"largest {min(g[1] for g in gaps):.2f}-{max(g[1] for g in gaps):.2f} ulp")
    for kind, (share, ulps) in sorted(worst.items()):
        print(f"largest clean, {kind}: unequal {share:.2e}, {ulps:.2f} ulp")
    for kind, (share, ulps) in sorted(worst_bwd.items()):
        print(f"largest clean backward, {kind}: unequal {share:.2e}, {ulps:.2f} ulp")


if __name__ == "__main__":
    _measure()
