"""The port's bf16 compute policy against the JAX package's, on the CPU.

JAX computes a `mixed_prec` config in bf16 with fp32 parameters
(gta_tpu/train/trainer.py:56, `build_model(cfg.model, dtype)`); the port
does the same through `Trainer.dtype` and the models' compute dtype
(gta_tpu_torch/models/layers.py).

  * Kernel level, tight: the plain versions of the fused GTA kernels (at
    head width 96 with the se3, so2 and so3 spans of msn_so3, alone and
    mixed) and of flash_core, on bf16 operands (computing in fp32 inside,
    the default `mxu_dtype`), against the JAX Pallas kernels in interpret
    mode on the same bf16 operands, forward values and the VJP through
    `jax.vjp`: the bf16 outputs (out, dq, dk, dv) within one bf16 ulp of
    each tensor's largest magnitude (both round the same fp32 values once;
    the orders of the fp32 sums differ), the fp32 trans_coeff cotangent
    within rtol 1e-4.
  * Model level: runs/msn/GTA/gta_so3, runs/msn/otherPEs/srt and
    runs/msn/GTA/gta_t2 (the sliced transforms around flash_core, whose
    rows stay fp32 under bf16 as on a TPU) shrunk
    (2 heads, one block each side, 5 views of 32x32, dropout 0), the same
    JAX weights and batch, in JAX and in the port, each in bf16 and fp32.
    The JAX models run with the TPU's numerics (`_tpu_numerics`): their
    attention through the Pallas kernels in interpret mode, and each bf16
    elementwise chain rounded once (tests/test_torch_bf16_layers.py). The
    criteria are the 1.5x rule of chip_smoke.py's
    bf16_card_vs_cpu_phase (and of the card tests' bf16 kernels), end to
    end: the port's bf16 result may sit at most BF16_RULE x as far (relative
    L2) from JAX's fp32 one as JAX's bf16 result with the TPU's rounding
    does:
      - pixels: port-bf16 vs JAX-fp32 at most 1.5x JAX-bf16 vs JAX-fp32;
      - one step's gradients, every parameter tensor concatenated: the same
        rule. Per tensor it is no statistic: a tensor of a few elements, or
        a scalar whose gradient is a sum that cancels, gives a ratio of two
        small random errors (over 6 + 6 item pairs up to 2.4 on a 3-element
        bias, 5.3 on a trans_coeff scalar, with no fault);
      - the port's bf16-vs-fp32 gap within 0.5-2x of JAX's (the policy is
        really applied);
      - parameters and optimizer state stay fp32, the loss is fp32, and a
        JAX fp32 parameter tree loads into the bf16 Trainer unchanged.
    Over 6 item pairs per renderer (numpy and the host renderer; `python -m
    tests.test_torch_bf16`) the pixel ratio stays in 0.59-0.91 and the
    gradient ratio in 0.64-1.28 for all three configs. A planted rounding
    fault (every bf16 Linear and LayerNorm output moved one bf16 ulp away
    from zero) fails them (pixels 1.24 / 2.10 / 2.03, gradients 1.82 /
    1.38 / 1.73). They are not
    per-layer checks (`python -m tests.test_torch_bf16 faults`): one
    layer's one-ulp shift stays inside the spread of clean pairs in every
    layer, and a skipped rounding lowers the error, which the 1.5x rules
    cannot see (the 0.5x policy floor caught one layer of 56, and every
    layer's skipped rounding in MSN SRT only). The per-layer checks, which
    catch either fault in every layer alone, are
    tests/test_torch_bf16_layers.py's.
  * The CLIs: train and evaluate on both published msn configs (shrunk,
    --device cpu) in bf16, and --bf16 forcing the policy on a CLEVR-TR
    config.

The CUDA kernels' bf16 instances run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import gta_tpu.ops.gta_fused as jgf
from gta_tpu.config import FDims as JFDims, GTAArgs as JGTAArgs
from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.ops.flash_core import flash_core as j_flash_core
from gta_tpu.ops.reps import decoder_reps as j_decoder_reps, encoder_reps as j_encoder_reps
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch import evaluate as t_evaluate
from gta_tpu_torch.config import FDims, GTAArgs, load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.ops import flash_core as fc, gta_fused as tgf
from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps
from gta_tpu_torch.train import __main__ as t_train
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import params_from_jax
from tests.conftest import random_se3
from tests.test_torch_train import _tiny_yaml

MSN_SO3 = "runs/msn/GTA/gta_so3/config.yaml"
MSN_SRT = "runs/msn/otherPEs/srt/config.yaml"
MSN_T2 = "runs/msn/GTA/gta_t2/config.yaml"
CLEVR_GTA = "runs/clevrtr/GTA/gta/config.yaml"
B, H = 2, 2
BF = torch.bfloat16

# ---------------------------------------------------------------------------
# Kernel level
# ---------------------------------------------------------------------------

# head width 96: msn_so3's spans alone and mixed (f_dims, so2 freqs, so3 degree)
MIXES = {
    "se3": (dict(se3=96), 0, 0),
    "so2": (dict(so2=96), 24, 0),
    "so3": (dict(so3=96), 0, 2),
    "msn_so3": (dict(se3=48, so3=24, so2=24), 6, 2),
}


def _bf16(rng, *shape):
    """A normal draw rounded to bf16, as float32 numpy (fed to both)."""
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(BF).float().numpy()


def _tokens(x):
    """[B, H, T, C] numpy -> token-major [B, T, H*C] bf16 torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B, x.shape[2], -1))).to(BF)


def _heads(x):
    return x.detach().float().reshape(B, x.shape[1], H, -1).transpose(1, 2).numpy()


def _assert_within_one_ulp(got, want, name):
    """got, want: bf16 values (as float32 numpy) of one tensor; each element
    within one bf16 ulp of the tensor's largest magnitude."""
    want = np.asarray(want, dtype=np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp, err_msg=name)


def _reps(rng, jargs, targs):
    """Decoder reps of both frameworks: 3 target views of 8 rays against 5
    input views of 8 tokens, input view 0 the identity camera."""
    coord = rng.rand(B, 5, 8, 2).astype(np.float32)
    tf = np.stack([random_se3(rng, 5) for _ in range(B)])
    tf[:, 0] = np.eye(4, dtype=np.float32)
    t_coord = rng.rand(B, 3, 8, 2).astype(np.float32)
    t_tf = np.stack([random_se3(rng, 3) for _ in range(B)])
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    jreps = j_decoder_reps(
        jargs, target_coord=jnp.asarray(t_coord), target_transforms=jnp.asarray(t_tf),
        input_coord=jnp.asarray(coord), input_transforms=jnp.asarray(tf),
        enc=j_encoder_reps(jargs, jnp.asarray(coord), jnp.asarray(tf), None),
    )
    treps = decoder_reps(
        targs, target_coord=t(t_coord), target_transforms=t(t_tf), input_coord=t(coord),
        input_transforms=t(tf), enc=encoder_reps(targs, t(coord), t(tf)),
    )
    return jreps, treps


@pytest.mark.parametrize("mix", list(MIXES))
def test_fused_gta_bf16_matches_jax_interpret_kernel(rng, mix):
    fd, so2, so3 = MIXES[mix]
    jargs = JGTAArgs(f_dims=JFDims(**fd), so2=so2, so3=so3)
    targs = GTAArgs(f_dims=FDims(**fd), so2=so2, so3=so3)
    jreps, treps = _reps(rng, jargs, targs)
    C, scale, tc = 96, 96**-0.5, 0.3
    q, k, v = (_bf16(rng, B, H, t, C) for t in (24, 40, 40))
    w = _bf16(rng, B, H, 24, C)

    def j_loss(q, k, v, tc):
        out = jgf.fused_gta_attention_v2(q, k, v, jreps, jargs, tc, scale, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, (0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(tc)
    )
    assert j_out.dtype == jnp.bfloat16 and j_grads[0].dtype == jnp.bfloat16
    leaves = [_tokens(x).requires_grad_() for x in (q, k, v)]
    ttc = torch.tensor([tc], requires_grad=True)
    out = tgf.fused_gta_attention_tokens(*leaves, H, treps, targs, ttc, scale)
    assert out.dtype == BF
    out.backward(_tokens(w))
    assert all(x.grad.dtype == BF for x in leaves)
    _assert_within_one_ulp(_heads(out), np.asarray(j_out, np.float32), "out")
    for x, want, name in zip(leaves, j_grads, ("dq", "dk", "dv")):
        _assert_within_one_ulp(_heads(x.grad), np.asarray(want, np.float32), name)
    if fd.get("se3"):  # trans_coeff reaches the tables through the se3 blocks only
        assert ttc.grad.dtype == torch.float32
        np.testing.assert_allclose(ttc.grad.item(), float(j_grads[3]), rtol=1e-4, err_msg="dtc")


@pytest.mark.parametrize("tq,tk", [(64, 64), (48, 80)])
def test_flash_core_bf16_matches_jax_interpret_kernel(rng, tq, tk):
    C = 64
    q, k, v, g = (_bf16(rng, B, H, t, C) for t in (tq, tk, tk, tq))
    j_out, vjp = jax.vjp(lambda q, k, v: j_flash_core(q, k, v, C**-0.5, True),
                         *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(g, jnp.bfloat16))
    leaves = [_tokens(x).requires_grad_() for x in (q, k, v)]
    out = fc.flash_core(*leaves, H, C**-0.5)
    assert out.dtype == BF
    out.backward(_tokens(g))
    _assert_within_one_ulp(_heads(out), np.asarray(j_out, np.float32), "out")
    for x, want, name in zip(leaves, j_grads, ("dq", "dk", "dv")):
        assert x.grad.dtype == BF
        _assert_within_one_ulp(_heads(x.grad), np.asarray(want, np.float32), name)


def test_emulated_bf16_rounding_is_coarser(rng):
    """mxu_dtype=bf16 (the TPU kernel's operand rounding) moves the plain
    versions' results by bf16's scale, where the default (fp32 inside)
    agrees with fp64 to fp32's."""
    args = GTAArgs(f_dims=FDims(se3=48, so3=24, so2=24), so2=6, so3=2)
    _, treps = _reps(rng, JGTAArgs(f_dims=JFDims(se3=48, so3=24, so2=24), so2=6, so3=2), args)
    t = tgf.fused_tables(treps, args, torch.tensor([0.3]))
    q, k, v = (torch.from_numpy(_bf16(rng, B, t_, H * 96)) for t_ in (24, 40, 40))
    t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)], t.nq, t.nk, t.v_transform)
    ref = tgf.gta_fused_fwd_plain(q.double(), k.double(), v.double(), t64, H, 96**-0.5)

    def rel(x):
        return ((x.double() - ref).norm() / ref.norm()).item()

    fp32 = rel(tgf.gta_fused_fwd_plain(q, k, v, t, H, 96**-0.5))
    emu = rel(tgf.gta_fused_fwd_plain(q, k, v, t, H, 96**-0.5, mxu_dtype=BF))
    assert fp32 < 1e-5 < 1e-3 < emu < 3e-2, (fp32, emu)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------


def _shrink(cfg, mixed_prec):
    """2 heads (of the config's head width), one attention block each side,
    5 views of 32x32, 40 target rays, dropout 0 (the frameworks draw
    different dropout bits); `mixed_prec` as given."""
    head = cfg.model.encoder.attdim // cfg.model.encoder.heads
    data = dataclasses.replace(cfg.data, dataset="synthetic", height=32, width=32, downsample=0, num_points=40)
    enc = dataclasses.replace(cfg.model.encoder, dim=64, attdim=2 * head, heads=2, num_att_blocks=1, dropout=0.0)
    dec = dataclasses.replace(cfg.model.decoder, z_dim=2 * head, heads=2, rmlp_dim=64, num_att_blocks=1,
                              dropout=0.0)
    return dataclasses.replace(cfg, data=data, model=dataclasses.replace(cfg.model, encoder=enc, decoder=dec),
                               training=dataclasses.replace(cfg.training, mixed_prec=mixed_prec))


def _items(cfg, idx):
    ds = SyntheticScenes(cfg.data, "train")
    return [ds[i] for i in idx]


def _jbatch(items):
    return jax.tree.map(jnp.asarray, j_collate(items))


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tpu_numerics(mp: pytest.MonkeyPatch):
    """Give the JAX models the TPU's numerics on the CPU, as
    tests/test_torch_bf16_layers.py states them: the layers' kernel calls go
    to the Pallas kernels in interpret mode (a TPU runs them compiled; on
    the CPU the layers would call them for a TPU), and each bf16
    elementwise chain rounds once, at its end, where XLA on the CPU rounds
    after each of its operations (a quarter of the outputs of a bf16 GELU,
    two fifths of a SiLU's, differ from the once-rounded ones there):
      - GELU (erf and tanh) and SiLU: computed in fp32, rounded once;
      - the sigmoid of the decoder's pixels (gta_tpu/models/decoder.py:222,
        its one caller, which casts it to fp32 at once): fp32, unrounded;
      - repast's scores `sim * scale / tau` before their cast to fp32
        (gta_tpu/models/layers.py:329-333): the product rounded to bf16,
        then the chain in fp32.
    The DiT's chains are tests/test_torch_dit._dit_numerics'."""
    import gta_tpu.models.layers as j_layers
    import gta_tpu.ops.flash as j_flash
    import gta_tpu.parallel.tp as j_tp

    f32 = jnp.float32
    gelu, silu, sigmoid = j_layers.nn.gelu, j_layers.nn.silu, j_layers.nn.sigmoid
    mp.setattr(j_layers.nn, "gelu", lambda x, approximate=True: gelu(x.astype(f32), approximate).astype(x.dtype))
    mp.setattr(j_layers.nn, "silu", lambda x: silu(x.astype(f32)).astype(x.dtype))
    mp.setattr(j_layers.nn, "sigmoid", lambda x: sigmoid(x.astype(f32)))
    einsum = j_layers.jnp.einsum

    def repast_scores_in_fp32(spec, *operands, **kwargs):
        out = einsum(spec, *operands, **kwargs)
        return out.astype(f32) if spec == "bhtnc,bhnlc->bhtnl" else out

    mp.setattr(j_layers.jnp, "einsum", repast_scores_in_fp32)

    fused = j_tp.fused_gta_attention_tp
    mp.setattr(j_tp, "fused_gta_attention_tp",
               lambda q, k, v, reps, args, tc, scale, interpret=False: fused(q, k, v, reps, args, tc, scale, True))
    mp.setattr(j_flash, "flash_attention", lambda q, k, v, sm_scale=1.0: j_flash_core(q, k, v, float(sm_scale), True))


def _jit_rounding_each_op(fn, *args):
    """fn(*args) compiled by XLA without excess precision: under jit XLA on
    the CPU keeps fp32 between the bf16 operations it fuses and rounds only
    what leaves the fusion, so a module's output could reach its consumer
    unrounded. Without it every bf16 operation rounds, as eager JAX and the
    convention's module boundaries do, and a patched chain
    (`_tpu_numerics`) rounds where its `astype` does."""
    exe = jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})
    return exe(*args)


@pytest.fixture(scope="module", params=[MSN_SO3, MSN_SRT, MSN_T2], ids=["msn_so3", "msn_srt", "msn_t2"])
def four(request):
    """{(framework, dtype): (pixels [B, T, 3], loss, grads by torch key)} of
    one shrunk published msn config on one batch, the same JAX init
    weights everywhere; and the port's bf16 Trainer after one step. The
    JAX models run their attention through the Pallas kernels (interpret
    mode), the TPU's path, whose bf16 rounding is the port's."""
    path = request.param
    tcfg = {mp: _shrink(load_config(path), mp) for mp in (True, False)}
    jcfg = {mp: _shrink(j_load_config(path), mp) for mp in (True, False)}
    jcfg = {mp: dataclasses.replace(c, training=dataclasses.replace(c.training, flash="fused"))
            for mp, c in jcfg.items()}
    items = _items(tcfg[False], (0, 1))
    jtr = {mp: JTrainer(jcfg[mp]) for mp in (True, False)}
    assert all(t.cfg.model.encoder.attn.flash for t in jtr.values())
    with pytest.MonkeyPatch.context() as patch:
        _tpu_numerics(patch)
        return _four(jtr, tcfg, items)


def _four(jtr, tcfg, items):
    params = jtr[False].init_state(_jbatch(items), seed=0).params
    weights = params_from_jax(jax.tree.map(np.asarray, params))
    out = {}
    for mp in (True, False):
        px, _ = jtr[mp].model.apply(params, _jbatch(items), deterministic=True)
        (loss, _), grads = jax.value_and_grad(jtr[mp]._loss_fn, has_aux=True)(
            params, _jbatch(items), jax.random.PRNGKey(0))
        out["jax", mp] = (np.asarray(px, np.float32), float(loss), params_from_jax(jax.tree.map(np.asarray, grads)))
        assert px.dtype == jnp.float32
        ttr = Trainer(tcfg[mp], device="cpu")
        ttr.model.load_state_dict(weights)
        assert all(torch.equal(p, weights[n]) for n, p in ttr.model.named_parameters())
        with torch.no_grad():
            tpx, _ = ttr.model(collate(items))
        loss, _, _ = ttr.loss_and_grads(collate(items))
        assert tpx.dtype == torch.float32 and loss.dtype == torch.float32
        out["port", mp] = (tpx.numpy(), loss.item(), {n: p.grad.clone() for n, p in ttr.model.named_parameters()})
        if mp:
            ttr.train_step(collate(items))
            bf16_trainer = ttr
    out.update(cfg=tcfg[True], weights=weights, items=items)
    return out, bf16_trainer


BF16_RULE = 1.5  # chip_smoke.py's bf16 rule: at most this many times the TPU rounding's error


def _rules(out, port_px=None, port_grads=None):
    """(pixel ratio, whole-gradient ratio): the port's bf16 error against
    JAX's fp32 result over JAX's bf16 error (TPU rounding) against it, for
    the pixels and for every gradient tensor concatenated. `port_*`
    replace the port's bf16 pixels / gradients (a planted fault)."""
    j32, j16 = out["jax", False], out["jax", True]
    px = out["port", True][0] if port_px is None else port_px
    grads = out["port", True][2] if port_grads is None else port_grads
    names = sorted(j32[2])

    def flat(g):
        return np.concatenate([np.asarray(g[n], np.float64).ravel() for n in names])

    return (_gap(px, j32[0]) / _gap(j16[0], j32[0]),
            _gap(flat({n: g.numpy() for n, g in grads.items()}), flat(j32[2]))
            / _gap(flat({n: g.numpy() for n, g in j16[2].items()}), flat(j32[2])))


def test_bf16_pixels_match_jax(four):
    out, _ = four
    jax_gap = _gap(out["jax", True][0], out["jax", False][0])
    port_gap = _gap(out["port", True][0], out["port", False][0])
    assert jax_gap > 1e-4, jax_gap  # bf16 really moves the pixels
    px_rule, _ = _rules(out)
    assert px_rule <= BF16_RULE, (px_rule, jax_gap)
    assert 0.5 <= port_gap / jax_gap <= 2.0, (port_gap, jax_gap)
    # and in fp32 the two frameworks agree as the fp32 tests hold them
    np.testing.assert_allclose(out["port", False][0], out["jax", False][0], atol=1e-4)


def test_bf16_grads_match_jax(four):
    out, _ = four
    assert sorted(out["port", True][2]) == sorted(out["jax", True][2])
    _, grad_rule = _rules(out)
    assert grad_rule <= BF16_RULE, grad_rule
    np.testing.assert_allclose(out["port", True][1], out["jax", True][1], rtol=1e-2)


def test_bf16_rules_catch_a_planted_rounding_fault(four, monkeypatch):
    """Every bf16 Linear and LayerNorm output of the port moved one bf16 ulp
    away from zero (a rounding that biases instead of rounding to nearest):
    the pixel or the gradient rule fails."""
    from gta_tpu_torch.models import layers

    out, _ = four

    def away(y):
        return torch.nextafter(y, torch.sign(y) * float("inf")) if y.dtype == BF else y

    for cls in (layers.Linear, layers.LayerNorm):
        monkeypatch.setattr(cls, "forward", lambda self, x, f=cls.forward: away(f(self, x)))
    ttr = Trainer(out["cfg"], device="cpu")
    ttr.model.load_state_dict(out["weights"])
    with torch.no_grad():
        px, _ = ttr.model(collate(out["items"]))
    ttr.loss_and_grads(collate(out["items"]))
    px_rule, grad_rule = _rules(out, px.numpy(), {n: p.grad.clone() for n, p in ttr.model.named_parameters()})
    assert px_rule > BF16_RULE or grad_rule > BF16_RULE, (px_rule, grad_rule)


def test_bf16_trainer_keeps_fp32_state(four):
    """After a bf16 step: fp32 parameters and fp32 AdamW moments."""
    _, trainer = four
    assert trainer.dtype == BF
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    states = [s for s in trainer.optimizer.state.values()]
    assert states and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32 for s in states)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def _msn_yaml(tmp_path, path):
    """A published msn config at the tests' width: 32x32 frames, 2 heads,
    one attention block each side, batch 2; mixed_prec as published."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["data"]["num_points"] = 40
    raw["data"]["kwargs"].update(height=32, width=32)
    enc, dec = raw["model"]["args"]["encoder_kwargs"], raw["model"]["args"]["decoder_kwargs"]
    head = 96 if path == MSN_SO3 else 64
    enc.update(dim=64, attdim=2 * head, heads=2, num_att_blocks=1)
    dec.update(z_dim=2 * head, heads=2, rmlp_dim=64, num_att_blocks=1)
    raw["training"].update(batch_size=2, print_every=1, checkpoint_every=2, backup_every=3, validate_every=2,
                           lr_warmup=1)
    assert raw["training"]["mixed_prec"]
    out = tmp_path / "config.yaml"
    out.write_text(yaml.safe_dump(raw))
    return str(out)


@pytest.mark.parametrize("path", [MSN_SO3, MSN_SRT], ids=["msn_so3", "msn_srt"])
def test_clis_run_published_msn_configs_in_bf16(tmp_path, capsys, path):
    cfg = _msn_yaml(tmp_path, path)
    t_train.main([cfg, "--synthetic", "--outdir", str(tmp_path / "run"), "--device", "cpu", "--exit-after", "1"])
    out = capsys.readouterr().out
    assert "compute dtype bfloat16" in out and "it=1, loss=" in out and "Iteration limit reached" in out
    got = t_evaluate.main([cfg, "--synthetic", "--device", "cpu", "--max-scenes", "1"])
    assert got["dtype"] == "bfloat16" and got["n_scenes"] == 1 and np.isfinite(got["psnr"])


def test_train_cli_bf16_flag_forces_the_policy(tmp_path, capsys):
    cfg = _tiny_yaml(tmp_path, CLEVR_GTA)
    assert not load_config(cfg).training.mixed_prec
    t_train.main([cfg, "--synthetic", "--outdir", str(tmp_path / "run"), "--device", "cpu", "--exit-after", "0",
                  "--bf16"])
    out = capsys.readouterr().out
    assert "compute dtype bfloat16" in out and "it=0, loss=" in out


# ---------------------------------------------------------------------------
# The model-level statistics over many item pairs (a probe, not a test)
# ---------------------------------------------------------------------------


def _item_pairs(pairs):
    """Print the model-level rules above on items (2p, 2p + 1), p < `pairs`,
    from the numpy renderer and from the host renderer (the tests hold them
    on items (0, 1) of the host renderer, the default), for the three shrunk msn
    configs, beside the per-tensor ratios the rules do not take. How often a
    rule passes over the pairs tells whether its limit sits in the tail of
    its distribution. From the repository root (CPU, ~30 min):
    JAX_PLATFORMS=cpu python -m tests.test_torch_bf16 [pairs]"""
    for path, name in ((MSN_SO3, "msn_so3"), (MSN_SRT, "msn_srt"), (MSN_T2, "msn_t2")):
        tcfg = {mp: _shrink(load_config(path), mp) for mp in (True, False)}
        jcfg = {mp: _shrink(j_load_config(path), mp) for mp in (True, False)}
        jcfg = {mp: dataclasses.replace(c, training=dataclasses.replace(c.training, flash="fused"))
                for mp, c in jcfg.items()}
        jtr = {mp: JTrainer(jcfg[mp]) for mp in (True, False)}
        for native in (False, True):
            ds = SyntheticScenes(tcfg[False].data, "train", use_native=native)
            for p in range(pairs):
                pair = (2 * p, 2 * p + 1)
                with pytest.MonkeyPatch.context() as patch:
                    _tpu_numerics(patch)
                    out, _ = _four(jtr, tcfg, [ds[i] for i in pair])
                px_rule, grad_rule = _rules(out)
                j16, j32, t16 = out["jax", True][2], out["jax", False][2], out["port", True][2]
                ratios = sorted(((_gap(t16[n].numpy(), j32[n]) / _gap(j16[n].numpy(), j32[n]), n)
                                 for n in t16), reverse=True)
                print(f"{name} {'native' if native else 'numpy'} items {pair}: pixels {px_rule:.3f}, gradients "
                      f"{grad_rule:.3f} (held <= {BF16_RULE}); per tensor, not held: "
                      + ", ".join(f"{r:.3f} ({n})" for r, n in ratios[:3]), flush=True)


def _unrounded(module):
    """The output of a bf16 Linear or LayerNorm before its rounding to bf16
    (fp32): the layer with its rounding skipped."""
    import torch.nn.functional as F

    from gta_tpu_torch.models import layers

    def forward(x):
        if isinstance(module, layers.Linear):
            return F.linear(x.to(BF).float(), module.weight.to(BF).float(), module.bias)
        return F.layer_norm(x.float(), module.normalized_shape, module.weight, module.bias, module.eps)
    return forward


def _one_ulp_away(module):
    """The layer's bf16 output moved one bf16 ulp away from zero."""
    forward = module.forward
    return lambda x: (lambda y: torch.nextafter(y, torch.sign(y) * float("inf")) if y.dtype == BF else y)(forward(x))


FAULTS = {"one_ulp_away": _one_ulp_away, "rounding_skipped": _unrounded}


def _faulted(out, fault, names):
    """The port's bf16 pixels and gradients with `fault` planted in the bf16
    Linear and LayerNorm layers named in `names` (all of them when None),
    and (pixel rule, gradient rule, the port's bf16-vs-fp32 pixel gap over
    JAX's): the model-level checks' three statistics."""
    from gta_tpu_torch.models import layers

    ttr = Trainer(out["cfg"], device="cpu")
    ttr.model.load_state_dict(out["weights"])
    for name, mod in ttr.model.named_modules():
        if isinstance(mod, (layers.Linear, layers.LayerNorm)) and (names is None or name in names):
            mod.forward = FAULTS[fault](mod)
    with torch.no_grad():
        px, _ = ttr.model(collate(out["items"]))
    ttr.loss_and_grads(collate(out["items"]))
    px_rule, grad_rule = _rules(out, px.numpy(), {n: p.grad.clone() for n, p in ttr.model.named_parameters()})
    policy = _gap(px.numpy(), out["port", False][0]) / _gap(out["jax", True][0], out["jax", False][0])
    return px_rule, grad_rule, policy


def _caught(px_rule, grad_rule, policy):
    """Whether the model-level checks fail: a 1.5x rule, or the 0.5-2x policy
    check of the port's bf16-vs-fp32 pixel gap."""
    return px_rule > BF16_RULE or grad_rule > BF16_RULE or not 0.5 <= policy <= 2.0


def _planted_faults():
    """Print the model-level checks' statistics with each planted fault
    (FAULTS) in each bf16 Linear and LayerNorm layer alone, and in all of
    them at once, on the tests' items for each shrunk msn config: which
    faults the checks catch. From the repository root (CPU, ~10 min):
    JAX_PLATFORMS=cpu python -m tests.test_torch_bf16 faults"""
    from gta_tpu_torch.models import layers

    for path, name in ((MSN_SO3, "msn_so3"), (MSN_SRT, "msn_srt"), (MSN_T2, "msn_t2")):
        tcfg = {mp: _shrink(load_config(path), mp) for mp in (True, False)}
        jcfg = {mp: _shrink(j_load_config(path), mp) for mp in (True, False)}
        jcfg = {mp: dataclasses.replace(c, training=dataclasses.replace(c.training, flash="fused"))
                for mp, c in jcfg.items()}
        jtr = {mp: JTrainer(jcfg[mp]) for mp in (True, False)}
        with pytest.MonkeyPatch.context() as patch:
            _tpu_numerics(patch)
            out, _ = _four(jtr, tcfg, _items(tcfg[False], (0, 1)))
        clean = _rules(out) + (_gap(out["port", True][0], out["port", False][0])
                               / _gap(out["jax", True][0], out["jax", False][0]),)
        print(f"{name} clean: pixels {clean[0]:.3f}, gradients {clean[1]:.3f}, policy {clean[2]:.3f}", flush=True)
        model = Trainer(tcfg[True], device="cpu").model
        mods = [n for n, m in model.named_modules() if isinstance(m, (layers.Linear, layers.LayerNorm))]
        for fault in FAULTS:
            rows = [(_faulted(out, fault, {m}), m) for m in mods]
            caught = [m for r, m in rows if _caught(*r)]
            worst = max(rows, key=lambda r: max(r[0][0], r[0][1]))
            every = _faulted(out, fault, None)
            print(f"{name} {fault}: one layer at a time, caught in {len(caught)} of {len(mods)} layers "
                  f"({', '.join(caught) or 'none'}); largest rules {worst[0][0]:.3f} / {worst[0][1]:.3f} "
                  f"({worst[1]}), policy {min(r[0][2] for r in rows):.3f}-{max(r[0][2] for r in rows):.3f}; "
                  f"every layer at once: pixels {every[0]:.3f}, gradients {every[1]:.3f}, policy {every[2]:.3f}, "
                  f"{'caught' if _caught(*every) else 'NOT caught'}", flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["faults"]:
        _planted_faults()
    else:
        _item_pairs(int(sys.argv[1]) if len(sys.argv) > 1 else 6)
