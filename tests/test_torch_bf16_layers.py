"""The TPU's bf16 rounding, layer by layer: every bf16 layer and elementwise
chain of the port held to the JAX package's on the CPU, each fed JAX's own
input, so that no upstream difference carries in.

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
    tests/test_torch_dit._dit_numerics). The chains on the bf16 paths, by
    JAX file and line, and the rounding each takes, on both sides:
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
        under --bf16): fp32, rounded once (models/layers.film).
    A result of one operation (a residual add, ReLU, a cast of fp32 data)
    rounds the same either way and is not listed. Not yet brought to the
    convention (ROADMAP Queue 3): camera_planar's two adds
    (gta_tpu/models/encoder.py:177, an option no config reaches) and the
    eager GTA transforms' bf16 products (gta_tpu/ops/gta.py, msn
    gta_so3_euclid's route).

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
and is held to the same rules. The configs: runs/msn/GTA/gta_so3,
runs/msn/otherPEs/srt and runs/msn/GTA/gta_t2 shrunk as
tests/test_torch_bf16._shrink shrinks them, and dit_gta as
tests/test_torch_dit._tiny_raw; every parameter drawn nonzero from a numpy
seed (LayerNorm scales about 1), so no bias or affine is trivial.

Bounds (SHARE), each beside its largest clean measurement over the four
configs (`python -m tests.test_torch_bf16_layers`, this CPU, torch 2.13,
jax 0.9.0):
    Linear 2e-3 (measured 1.95e-4: one element of 5,120), Conv2d 2e-3
    (1.95e-4), LayerNorm 2e-3 (6.5e-5), Embedding 0 (0), the bf16 chains
    2e-3 (GELU 3.2e-4; SiLU, the modulations and the gated residuals 0:
    every DiT tensor is bit-equal), the fp32 pixels 0.05 (8.3e-3: two of 240
    elements, one fp32 ulp, the two sigmoids' own rounding). The largest
    clean difference is one ulp (Linear) at the larger of the element and
    the RMS. Planted, the faults make 9.1 % (op by op, a gated
    residual) to 100 % of an output's elements unequal.

Planted faults (`test_a_planted_fault_fails_its_layer`): each fault alone in
each layer or chain must fail that layer's check, N of N:
  * one_ulp_away: the output moved one ulp away from zero;
  * rounding_skipped: the output left in fp32 before its last rounding
    (not planted in the pixels, which end in fp32);
  * op_by_op: a chain rounded to bf16 after each of its operations, as XLA
    on the CPU rounds it (chains only).
The card side of these checks, at full width: chip_smoke.py's
bf16_layer_phase.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from gta_tpu.config import load_config as j_load_config
from gta_tpu.train.dit_trainer import DiTTrainer as JDiTTrainer, dit_config_from_dict as j_dit_config_from_dict
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch.config import load_config
from gta_tpu_torch.models import decoder as t_decoder, dit as t_dit, layers
from gta_tpu_torch.train.dit_trainer import DiTTrainer, dit_config_from_dict
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import flax_path_to_torch_key, params_from_jax
from tests.test_torch_bf16 import FAULTS as MODEL_FAULTS, MSN_SO3, MSN_SRT, MSN_T2, _items, _jbatch, \
    _jit_rounding_each_op, _shrink, _tpu_numerics
from tests.test_torch_dit import _batch, _dit_numerics, _random_params, _tiny_raw

BF = torch.bfloat16
CONFIGS = {"msn_so3": MSN_SO3, "msn_srt": MSN_SRT, "msn_t2": MSN_T2, "dit_gta": None}
SHARE = {"Linear": 2e-3, "Conv2d": 2e-3, "LayerNorm": 2e-3, "Embedding": 0.0, "pixels": 0.05, "chain": 2e-3}
LAYERS = ("Linear", "Conv2d", "LayerNorm", "Embedding")
LEAVES = {"Dense": "kernel", "Conv": "kernel", "LayerNorm": "scale", "Embed": "embedding"}  # a flax param per module


@dataclasses.dataclass
class Check:
    """One layer or chain: the port's function of JAX's operands `args`,
    JAX's output `want`; `unrounded`, the port's value before its last
    rounding (None where it ends in fp32); `op_by_op`, a chain rounded after
    each operation (None for a layer)."""

    name: str
    kind: str
    port: object
    args: tuple
    want: torch.Tensor
    unrounded: object = None
    op_by_op: object = None

    def share_and_ulps(self, got):
        """(share of unequal elements, the largest difference in ulps of the
        output dtype at the larger of JAX's element and the tensor's RMS)."""
        want = self.want.double()
        mag = torch.maximum(want.abs(), want.square().mean().sqrt())
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - (7 if self.want.dtype == BF else 23))
        diff = (got.double() - want).abs()
        return (got != self.want).double().mean().item(), (diff / ulp).max().item()

    def holds(self, got) -> bool:
        share, ulps = self.share_and_ulps(got)
        return got.dtype == self.want.dtype and share <= SHARE.get(self.kind, SHARE["chain"]) and ulps <= 1.0


def _torch(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(BF)
    return torch.from_numpy(x.copy())


def _capture(apply, *args):
    """apply(*args) under jit, every bf16 operation rounded, with each flax
    module call's array inputs and output (the first, for a tuple)
    captured: ({module path: (inputs, output)} as torch tensors, {module
    path: flax class name})."""
    types = {}

    def run(*args):
        calls = {}

        def record(next_fun, a, kw, ctx):
            out = next_fun(*a, **kw)
            if ctx.method_name == "__call__":
                path = "/".join(ctx.module.path)
                assert path not in calls, path  # one call per module
                types[path] = type(ctx.module).__name__
                calls[path] = (tuple(x for x in a if isinstance(x, jax.Array)), out[0] if isinstance(out, tuple) else out)
            return out

        with nn.intercept_methods(record):
            apply(*args)
        return calls

    got = _jit_rounding_each_op(run, *args)  # a consumer takes the rounded value captured
    return {p: (tuple(_torch(x) for x in a), _torch(o)) for p, (a, o) in got.items()}, types


def _nonzero_params(shapes, seed):
    """tests/test_torch_dit._random_params (kernels N(0, 1/fan_in), biases
    N(0, 0.1^2)), with LayerNorm scales 1 + N(0, 0.1^2)."""
    params = _random_params(shapes, seed)
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(1 + 0.1 * rng.randn(*x.shape), jnp.float32) if p[-1].key == "scale" else x, params)


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


def _layer_checks(model, calls, types):
    """A Check per captured flax Dense / Conv / LayerNorm / Embed: the port
    module of the same name on JAX's input."""
    checks = []
    for path, (args, want) in calls.items():
        leaf = LEAVES.get(types[path])
        if leaf is None:
            continue
        name = flax_path_to_torch_key(tuple(path.split("/")) + (leaf,)).rsplit(".", 1)[0]
        mod = model.get_submodule(name)
        x = args[0]
        if isinstance(mod, torch.nn.Embedding):  # the table's cast is its owner's (models/dit.LabelEmbedder)
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            checks.append(Check(name, "Embedding", lambda y, o=owner: o(y.long()), (x,), want,
                                lambda y, m=mod: m(y.long())))
        elif isinstance(mod, layers.Conv2d):
            def nhwc(f):
                return lambda x: f(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

            def exact(x, m=mod):
                return F.conv2d(x.float(), m.weight.to(BF).float(), m.bias, m.stride, m.padding)

            checks.append(Check(name, "Conv2d", nhwc(mod), (x,), want, nhwc(exact)))
        elif isinstance(mod, layers.Linear):
            checks.append(Check(name, "Linear", mod, (x,), want,
                                lambda x, m=mod: F.linear(x.float(), m.weight.to(BF).float(), m.bias)))
        else:
            assert isinstance(mod, layers.LayerNorm), name
            checks.append(Check(name, "LayerNorm", mod, (x,), want,
                                lambda x, m=mod: F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps)))
    return checks


def _nvs_chains(model, calls):
    """The NVS configs' chains: each FeedForward's erf GELU, the pixels."""
    checks = []
    for path in calls:
        if path.split("/")[-1].startswith("ff_"):
            up, down = calls[path + "/Dense_0"], calls[path + "/Dense_1"]
            name = flax_path_to_torch_key(tuple(path.split("/")) + ("Dense_0", "kernel")).replace("net.0.weight", "net.1")
            act = model.get_submodule(name)
            checks.append(Check(name + " (GELU, erf)", "gelu", act, (up[1],), down[0][0], _fp32(act), GELU_ERF_OPS))
    h = calls["decoder/render_mlp_out"][1]
    checks.append(Check("decoder pixels (sigmoid, fp32)", "pixels", t_decoder.render_pixels, (h,), calls["decoder"][1],
                        None, lambda h: torch.sigmoid(h).float()))
    return checks


def _dit_chains(model, calls):
    """dit_gta's chains: the timestep MLP's SiLU; in each block SiLU(c), the
    two modulations, the gated residuals and the tanh GELU; the final
    layer's SiLU(c) and modulation."""
    def gelu_tanh(h):
        return F.gelu(h, approximate="tanh")

    silu = ("silu", F.silu, _fp32(F.silu), SILU_OPS)
    gelu = ("gelu", gelu_tanh, _fp32(gelu_tanh), GELU_TANH_OPS)
    modulate = ("modulate", t_dit._modulate, _fp32(t_dit._modulate), MODULATE_OPS)
    gated = ("gated", t_dit._gated, _fp32(t_dit._gated), GATED_OPS)

    def check(name, chain, args, want):
        kind, port, unrounded, ops = chain
        return Check(f"{name} ({kind})", kind, port, args, want, unrounded, ops)

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


def _config(name):
    """(the port's bf16 model with JAX's weights, its Checks) for one config."""
    if name == "dit_gta":
        raw = _tiny_raw("gta", mixed_prec=True)
        jtr = JDiTTrainer(j_dit_config_from_dict(raw))
        b = _batch()
        args = (jnp.asarray(b["image"]), jnp.asarray(b["t"]), jnp.asarray(b["label"]))
        params = _nonzero_params(jax.eval_shape(lambda: jtr.init_state({"image": b["image"], "label": b["label"]}).params),
                                 seed=7)
        model = DiTTrainer(dit_config_from_dict(raw), device="cpu").model
        numerics, chains = _dit_numerics, _dit_chains
    else:
        path = CONFIGS[name]
        jcfg = _shrink(j_load_config(path), True)
        jtr = JTrainer(dataclasses.replace(jcfg, training=dataclasses.replace(jcfg.training, flash="fused")))
        tcfg = _shrink(load_config(path), True)
        args = (_jbatch(_items(tcfg, (0, 1))),)
        params = _nonzero_params(jax.eval_shape(lambda: jtr.model.init(jax.random.PRNGKey(0), *args)), seed=3)
        model = Trainer(tcfg, device="cpu").model
        numerics, chains = _tpu_numerics, _nvs_chains
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with pytest.MonkeyPatch.context() as patch:
        numerics(patch)
        calls, types = _capture(lambda p, *a: jtr.model.apply(p, *a, deterministic=True), params, *args)
    return model, _layer_checks(model, calls, types) + chains(model, calls)


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request):
    torch.manual_seed(0)
    return request.param, *_config(request.param)


def _run(check, fault=None):
    """The port's output of `check` on JAX's operands, with `fault` planted."""
    with torch.no_grad():
        if fault == "rounding_skipped":
            return check.unrounded(*check.args)
        if fault == "op_by_op":
            return check.op_by_op(*check.args)
        got = check.port(*check.args)
        if fault == "one_ulp_away":
            got = torch.nextafter(got, torch.where(got < 0, -torch.inf, torch.inf).to(got.dtype))
        return got


FAULTS = (*MODEL_FAULTS, "op_by_op")  # the model-level checks' faults, and a chain rounded op by op


def _planted(checks, fault):
    """The checks `fault` can be planted in."""
    return [c for c in checks if {"rounding_skipped": c.unrounded, "op_by_op": c.op_by_op}.get(fault, True)]


def test_every_bf16_layer_and_chain_matches_jax(config):
    name, model, checks = config
    failed = [(c.name, c.share_and_ulps(got), got.dtype) for c in checks if not c.holds(got := _run(c))]
    assert not failed, failed
    # every bf16 layer of the port is checked, and every chain kind of the config
    kinds = (layers.Linear, layers.Conv2d, layers.LayerNorm, torch.nn.Embedding)
    every = {n for n, m in model.named_modules() if isinstance(m, kinds)}
    assert every == {c.name for c in checks if c.kind in LAYERS}, every ^ {c.name for c in checks}
    want = {"gelu", "pixels"} if name != "dit_gta" else {"silu", "modulate", "gated", "gelu"}
    assert {c.kind for c in checks if c.kind not in LAYERS} == want


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_its_layer(config, fault):
    """`fault` planted in each layer or chain alone fails that one's check:
    N of N."""
    name, _, checks = config
    planted = _planted(checks, fault)
    missed = [c.name for c in planted if c.holds(_run(c, fault))]
    print(f"{name} {fault}: caught in {len(planted) - len(missed)} of {len(planted)}")
    assert planted and not missed, missed


# ---------------------------------------------------------------------------
# The chains off the four configs, as functions against the JAX expression
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
    the largest per kind, and each fault's catches, for the four configs.
    From the repository root (CPU, ~1 min):
    JAX_PLATFORMS=cpu python -m tests.test_torch_bf16_layers"""
    worst = {}
    for name in CONFIGS:
        torch.manual_seed(0)
        _, checks = _config(name)
        for c in checks:
            share, ulps = c.share_and_ulps(_run(c))
            kind = c.kind if c.kind in LAYERS else "chain " + c.kind
            worst[kind] = max(worst.get(kind, (0, 0)), (share, ulps))
            print(f"{name} {c.name}: {c.want.numel()} elements, unequal {share:.2e}, largest {ulps:.2f} ulp", flush=True)
        for fault in FAULTS:
            planted = _planted(checks, fault)
            shares = [c.share_and_ulps(_run(c, fault))[0] for c in planted]
            print(f"{name} {fault}: caught in {sum(not c.holds(_run(c, fault)) for c in planted)} of {len(planted)}, "
                  f"unequal {min(shares):.2e}-{max(shares):.2e}")
    for kind, (share, ulps) in sorted(worst.items()):
        print(f"largest clean, {kind}: unequal {share:.2e}, {ulps:.2f} ulp")


if __name__ == "__main__":
    _measure()
