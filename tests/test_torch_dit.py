"""The DiT family in the port (gta_tpu_torch/models/dit.py,
train/dit_trainer.py, train_dit.py, data/images.py,
utils/stripe_classifier.py, scripts/eval_dit_samples.py) against the JAX
package's, on the CPU.

The models are tests/test_dit.py's tiny config (8x8x3 images, patch 2,
hidden 32, depth 2, 2 heads of 16; GTA f_dims triv 8 + so2 8, 2 SO(2)
frequencies; 4 classes, T = 50), both methods: 'gta' and the stock ''.
Every JAX parameter is drawn nonzero from a numpy seed (adaLN-Zero
initialises the modulation and the output projection to zero, so a freshly
built DiT outputs exactly 0 and would compare zeros) and carried across by
`weights.params_from_jax`. The JAX models run with the TPU's numerics
(`_dit_numerics`): GTA through gta_tpu.ops.gta_pallas.fused_gta_attention
and method '' through flash_core, both Pallas kernels in interpret mode,
and each bf16 elementwise chain (GELU, SiLU, the modulation, the gated
residuals) rounded once (tests/test_torch_bf16_layers.py). Label dropout is a mask the port's trainer draws; the
JAX side gets the same mask as the dropped labels.

Tolerances: fp32 outputs within 1e-4 (atol; outputs of order 1-4), fp32
gradients by parameter within atol 5e-5 / rtol 1e-3 and the loss metrics
within 1e-5; bf16 (mixed_prec) outputs and the whole gradient (every
parameter tensor concatenated) at most BF16_RULE (1.5) times as far
(relative L2) from JAX's fp32 result as JAX's own bf16 result is (the
model-level rule of tests/test_torch_bf16.py); one AdamW step on the same
gradients within 1e-6 of optax's; DDIM through CFG with JAX's draws
handed in within 1e-4; procedural images and the classifier's predictions
exactly equal.
"""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as nn

import gta_tpu.models.dit as j_dit
import gta_tpu.ops.gta_pallas as j_gta_pallas
from gta_tpu.data.images import SyntheticImages as JSyntheticImages, collate_images as j_collate_images
from gta_tpu.train import diffusion as jd
from gta_tpu.train.dit_trainer import DiTTrainer as JDiTTrainer, dit_config_from_dict as j_dit_config_from_dict
from gta_tpu.utils import stripe_classifier as j_stripe
from gta_tpu_torch.data.images import ImageNetTFDS, SyntheticImages, collate_images
from gta_tpu_torch.models.dit import DiT, build_dit, sincos_pos_embed
from gta_tpu_torch.scripts import eval_dit_samples
from gta_tpu_torch.train import diffusion as td
from gta_tpu_torch.train.checkpoint import Checkpointer
from gta_tpu_torch.train.dit_trainer import DiTTrainer, dit_config_from_dict, load_dit_config
from gta_tpu_torch.utils import stripe_classifier
from gta_tpu_torch.weights import params_from_jax
from tests.test_torch_bf16 import _jit_rounding_each_op, _tpu_numerics

BF16_RULE = 1.5
FWD_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-3
PUBLISHED = ("runs/imagenet/DiT/dit_gta/config.yaml", "runs/imagenet/DiT/dit_base/config.yaml")


def _tiny_raw(method="gta", mixed_prec=False, **training):
    """tests/test_dit.py's tiny DiT as a run-config dict (`flash: fused`:
    the JAX trainer's TPU routing; the port ignores the key)."""
    gta = {"method": {"name": "gta", "args": {"f_dims": {"triv": 8, "so2": 8}, "so2": 2}}}
    return {
        "data": {"dataset": "imagenet", "path": None, "num_images": 64},
        "model": {"model_type": "dit", "args": {"dit_kwargs": {
            "input_size": 8, "patch_size": 2, "in_channels": 3, "hidden_size": 32, "depth": 2, "heads": 2,
            "num_classes": 4, "timesteps": 50, "attn_args": gta if method == "gta" else {"method": {"name": ""}},
        }}},
        "training": {"mixed_prec": mixed_prec, "flash": "fused", "batch_size": 4, "lr": 1e-3, "lr_warmup": 2,
                     **training},
    }


def _round_once(fn):
    """fn over its operands in fp32, rounded once to the first's dtype."""
    return lambda x, *rest: fn(x.astype(jnp.float32), *(r.astype(jnp.float32) for r in rest)).astype(x.dtype)


class _TPUDiTBlock(j_dit.DiTBlock):
    """gta_tpu/models/dit.py's DiTBlock (:183-203, the same modules and
    names) with its gated residuals x + gate * h rounded once, as a TPU
    fuses them."""

    @nn.compact
    def __call__(self, x, c, reps):
        mod = nn.Dense(6 * self.hidden_size, dtype=self.dtype, kernel_init=nn.initializers.zeros_init(),
                       name="ada_mod")(nn.silu(c))
        s1, g1, gate1, s2, g2, gate2 = jnp.split(mod, 6, -1)
        gated = _round_once(lambda x, gate, h: x + gate[:, None] * h)
        ln = lambda n: nn.LayerNorm(use_bias=False, use_scale=False, dtype=self.dtype, name=n)  # noqa: E731
        h = j_dit._modulate(ln("norm1")(x), s1, g1)
        x = gated(x, gate1, j_dit.GTASelfAttention(self.hidden_size, self.heads, self.attn, self.dtype,
                                                   name="attn")(h, reps))
        h = j_dit._modulate(ln("norm2")(x), s2, g2)
        h = nn.Dense(int(self.hidden_size * self.mlp_ratio), dtype=self.dtype, name="mlp_fc1")(h)
        h = nn.gelu(h, approximate=True)
        return gated(x, gate2, nn.Dense(self.hidden_size, dtype=self.dtype, name="mlp_fc2")(h))


def _dit_numerics(mp: pytest.MonkeyPatch):
    """The TPU's numerics for the JAX DiT on the CPU (tests/test_torch_bf16.
    _tpu_numerics, which rounds GELU and SiLU once, plus the DiT's own):
    its GTA entry, which gta_tpu/models/dit.py imports at call time, goes to
    the Pallas kernels in interpret mode, and its chains round once, in
    fp32 from their bf16 operands: the modulation x * (1 + scale) + shift
    (`_modulate`, :132, every block's two and the final layer's, :263) and
    the gated residuals (:195, :203, `_TPUDiTBlock`)."""
    _tpu_numerics(mp)
    fused = j_gta_pallas.fused_gta_attention
    mp.setattr(j_gta_pallas, "fused_gta_attention",
               lambda q, k, v, reps, args, tc, scale, interpret=False: fused(q, k, v, reps, args, tc, scale, True))
    mp.setattr(j_dit, "_modulate", _round_once(lambda x, shift, scale: x * (1.0 + scale[:, None]) + shift[:, None]))
    mp.setattr(j_dit, "DiTBlock", _TPUDiTBlock)


def _random_params(shapes, seed):
    """Every leaf nonzero from a numpy seed: Dense / Conv kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), the label table N(0, 1/features)."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        fan = int(np.prod(s.shape[:-1])) if name == "kernel" else s.shape[-1]
        std = 0.1 if name == "bias" else 1.0 / np.sqrt(fan)
        return jnp.asarray((rng.randn(*s.shape) * std).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(seed=0, B=3):
    rng = np.random.RandomState(seed)
    return {
        "image": np.tanh(rng.randn(B, 8, 8, 3)).astype(np.float32),
        "label": np.array([1, 3, 0, 2][:B], np.int32),
        "t": np.array([0, 17, 49, 30][:B]),
        "noise": rng.randn(B, 8, 8, 3).astype(np.float32),
        "drop": np.array([False, True, False, True][:B]),
    }


def _jax_loss(jtr, params, b):
    """JAX's hybrid loss at the batch's draws, with the model's output at
    x_t as aux; label dropout as the dropped labels (the null label where
    `drop`)."""
    mcfg = jtr.cfg.model
    y = jnp.where(jnp.asarray(b["drop"]), mcfg.null_label, jnp.asarray(b["label"]))
    x0, t, noise = jnp.asarray(b["image"]), jnp.asarray(b["t"]), jnp.asarray(b["noise"])
    out = jtr.model.apply(params, jd.q_sample(jtr.sch, x0, t, noise), t, y, deterministic=True)
    loss, metrics = jd.training_loss(jtr.sch, lambda *_: out, x0, t, noise, learn_sigma=mcfg.learn_sigma,
                                     vb_weight=mcfg.vb_weight)
    return loss, (metrics, out)


def _port_loss(trainer, b):
    """The port trainer's loss at the batch's draws, and the model's output
    at x_t."""
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    x0, tt, noise, labels, drop = t(b["image"]), t(b["t"]), t(b["noise"]), t(b["label"]).long(), t(b["drop"])
    out = trainer.model(td.q_sample(trainer.sch, x0, tt, noise), tt, labels, drop)
    loss, metrics = td.training_loss(trainer.sch, lambda *_: out, x0, tt, noise, True, trainer.cfg.model.vb_weight)
    return loss, metrics, out


@pytest.fixture(scope="module", params=["gta", ""], ids=["gta", "base"])
def both(request):
    """One method's JAX and port results on one batch at the same random
    weights: {(framework, bf16): (output, metrics, grads by torch key)},
    plus the weights, the JAX fp32 trainer and its params."""
    method = request.param
    b = _batch()
    jtr = {mp: JDiTTrainer(j_dit_config_from_dict(_tiny_raw(method, mp))) for mp in (False, True)}
    assert all(t.cfg.model.attn.flash and t.cfg.model.attn.fused for t in jtr.values())
    shapes = jax.eval_shape(lambda: jtr[False].init_state({"image": b["image"], "label": b["label"]}).params)
    params = _random_params(shapes, seed=7)
    weights = params_from_jax(jax.tree.map(np.asarray, params))
    out = {"weights": weights, "jtr": jtr[False], "params": params, "batch": b, "method": method}
    with pytest.MonkeyPatch.context() as patch:
        _dit_numerics(patch)
        for mp in (False, True):
            fn = jax.value_and_grad(lambda p, mp=mp: _jax_loss(jtr[mp], p, b), has_aux=True)
            (_, (metrics, px)), grads = _jit_rounding_each_op(fn, params)
            out["jax", mp] = (np.asarray(px), {k: float(v) for k, v in metrics.items()},
                              params_from_jax(jax.tree.map(np.asarray, grads)))
            if not mp:
                out["jax_grads"] = grads
    for mp in (False, True):
        trainer = DiTTrainer(dit_config_from_dict(_tiny_raw(method, mp)), device="cpu")
        trainer.model.load_state_dict(weights)
        loss, metrics, px = _port_loss(trainer, b)
        loss.backward()
        assert px.dtype == torch.float32 and loss.dtype == torch.float32
        out["port", mp] = (px.detach().numpy(), {k: v.item() for k, v in metrics.items()},
                           {n: p.grad.clone() for n, p in trainer.model.named_parameters()})
        # the trainer's own loss (drop mask inside the model) is the same function
        assert trainer.loss(*(torch.from_numpy(np.asarray(b[k])) for k in ("image", "label", "t", "noise", "drop")))[
            0].item() == loss.item()
    return out


def test_fp32_forward_matches_jax(both):
    got, want = both["port", False][0], both["jax", False][0]
    assert got.shape == want.shape == (3, 8, 8, 6)  # at x_t, the dropped labels
    assert np.abs(want).max() > 0.5  # every parameter nonzero: not a comparison of zeros
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def test_fp32_loss_and_grads_match_jax(both):
    (_, tm, tg), (_, jm, jg) = both["port", False], both["jax", False]
    assert sorted(tm) == sorted(jm) == ["loss", "mse", "vb"]
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=0, err_msg=k)
    assert sorted(tg) == sorted(jg)
    for name in jg:
        np.testing.assert_allclose(tg[name].numpy(), jg[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    # labels 1, 3, 0 with item 1 dropped: rows 1, 0 and the null row 4 get gradients, rows 2 and 3 none
    table = tg["y_embed.table.weight"].numpy()
    assert np.abs(table[[0, 1, 4]]).min(axis=1).max() > 0 and np.abs(table[[2, 3]]).max() == 0


def test_euclid_gta_forward_matches_jax():
    """GTA with euclid_sim (no published DiT config has it): both frameworks
    take it in eager, the JAX DiT with the plain dot-product similarity
    (gta_tpu/models/dit.py:162-171); fp32 outputs within 1e-4."""
    raw = _tiny_raw("gta")
    raw["model"]["args"]["dit_kwargs"]["attn_args"]["method"]["args"]["euclid_sim"] = True
    jtr = JDiTTrainer(j_dit_config_from_dict(raw))
    assert not jtr.cfg.model.attn.fused
    b = _batch()
    params = _random_params(jax.eval_shape(lambda: jtr.init_state({"image": b["image"], "label": b["label"]}).params),
                            seed=8)
    want = np.asarray(jtr.model.apply(params, *(jnp.asarray(b[k]) for k in ("image", "t", "label"))))
    model = build_dit(dit_config_from_dict(raw).model)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.asarray(b[k])) for k in ("image", "t", "label"))).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_meets_the_tpu_rounding_rule(both):
    """Pixels and the whole gradient under mixed_prec: the port's bf16
    result at most 1.5x as far from JAX's fp32 one as JAX's bf16 result."""
    j32, j16, t16 = both["jax", False], both["jax", True], both["port", True]
    assert _gap(t16[0], j32[0]) <= BF16_RULE * _gap(j16[0], j32[0])
    names = sorted(j32[2])

    def flat(g):
        return np.concatenate([np.asarray(g[n], np.float64).ravel() for n in names])

    j32g, j16g = flat({n: g.numpy() for n, g in j32[2].items()}), flat({n: g.numpy() for n, g in j16[2].items()})
    t16g = flat({n: g.numpy() for n, g in t16[2].items()})
    assert _gap(t16g, j32g) <= BF16_RULE * _gap(j16g, j32g)
    # the policy is applied: bf16 is measurably off fp32 in both frameworks
    assert _gap(t16[0], both["port", False][0]) > 1e-4 and _gap(j16[0], j32[0]) > 1e-4


def test_adamw_steps_match_optax(both):
    """Two optimizer steps on JAX's fp32 gradients: the port's AdamW under
    warmup (lr 0, then peak / 2) against the JAX trainer's optax chain."""
    jtr, params = both["jtr"], both["params"]
    grads = both["jax_grads"]
    opt = jtr.tx.init(params)
    jp = params
    for _ in range(2):
        updates, opt = jtr.tx.update(grads, opt, jp)
        jp = optax.apply_updates(jp, updates)
    trainer = DiTTrainer(dit_config_from_dict(_tiny_raw(both["method"])), device="cpu")
    trainer.model.load_state_dict(both["weights"])
    tgrads = params_from_jax(jax.tree.map(np.asarray, grads))
    lrs = []
    for _ in range(2):
        for n, p in trainer.model.named_parameters():
            p.grad = tgrads[n].clone()
        lrs.append(trainer.scheduler.get_last_lr()[0])
        trainer.optimizer.step()
        trainer.scheduler.step()
    assert lrs == [0.0, 0.5e-3]
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    for n, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=0, err_msg=n)


def test_ddim_cfg_sample_with_jax_draws(both):
    """CFG + DDIM (eta 0, 5 steps, guidance 4) of the tiny DiT in fp32, the
    JAX sampler's draws handed to the port's."""
    jtr, params = both["jtr"], both["params"]
    labels, shape, key = np.array([0, 3]), (2, 8, 8, 3), jax.random.PRNGKey(5)
    with pytest.MonkeyPatch.context() as patch:
        _dit_numerics(patch)
        fn = jd.cfg_model_fn(lambda x, t, y: jtr.model.apply(params, x, t, y, deterministic=True),
                             jnp.asarray(labels), 4, 4.0)
        want = np.asarray(jd.ddim_sample(jtr.sch, fn, shape, key, steps=5))
        key, r0 = jax.random.split(key)
        draws = [np.asarray(jax.random.normal(r0, shape, jnp.float32))]
        for _ in range(5):
            key, rn = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(rn, shape, jnp.float32)))
    trainer = DiTTrainer(dit_config_from_dict(_tiny_raw(both["method"])), device="cpu")
    trainer.model.load_state_dict(both["weights"])
    it = iter(draws)
    fn = td.cfg_model_fn(lambda x, t, y: trainer.model(x, t, y), torch.from_numpy(labels), 4, 4.0)
    with torch.no_grad():
        got = td.ddim_sample(trainer.sch, fn, shape, lambda s: torch.from_numpy(next(it).copy()), steps=5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("method", ["gta", ""], ids=["gta", "base"])
def test_fresh_dit_is_zero_and_init_is_flax_like(method):
    """adaLN-Zero: a freshly built DiT outputs exactly 0. The other weights
    are drawn as flax draws them, checked by statistics at hidden 128:
    lecun-normal kernels (std sqrt(1/fan_in), truncated at 2 std), zero
    biases, the label table N(0, 1/hidden)."""
    raw = _tiny_raw(method)
    raw["model"]["args"]["dit_kwargs"].update(hidden_size=128, heads=2)
    if method == "gta":
        raw["model"]["args"]["dit_kwargs"]["attn_args"]["method"]["args"] = {"f_dims": {"triv": 32, "so2": 32},
                                                                            "so2": 8}
    cfg = dit_config_from_dict(raw).model
    model = build_dit(cfg, generator=torch.Generator().manual_seed(3))
    b = _batch()
    with torch.no_grad():
        out = model(*(torch.from_numpy(np.asarray(b[k])) for k in ("image", "t", "label")))
    assert torch.equal(out, torch.zeros_like(out))
    for name, p in model.named_parameters():
        w = p.detach().numpy()
        if name.endswith("bias") or name.split(".")[0] in ("final_mod", "final_proj") or ".ada_mod." in name:
            assert np.all(w == 0), name
        elif name == "y_embed.table.weight":
            assert abs(w.std() * np.sqrt(128) - 1) < 0.05, name
        else:
            std = np.sqrt(1.0 / w[0].size)
            assert abs(w.std() / std - 1) < 0.1 and np.abs(w).max() <= 2 * std / 0.8796 + 1e-6, name


def test_grid_reps_take_make_2dcoord_and_jax_rotors():
    """models/dit.grid_reps builds make_2dcoord's grid on the device: the
    same bits, and the JAX DiT's rotor tables (`DiT._reps`) at 1e-6."""
    from gta_tpu.models.dit import DiT as JDiT
    from gta_tpu_torch.geometry.coords import make_2dcoord
    from gta_tpu_torch.models.dit import grid_reps

    jcfg = j_dit_config_from_dict(_tiny_raw("gta")).model
    cfg = dit_config_from_dict(_tiny_raw("gta")).model
    reps = grid_reps(cfg, 3, "cpu")
    jreps = JDiT(jcfg)._reps(3)
    for got, want in zip(reps.so2_q, jreps.so2_q):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert reps.se3_q is None and reps.so3_q is None and grid_reps(dit_config_from_dict(_tiny_raw("")).model, 3,
                                                                    "cpu") is None
    i = torch.arange(16, dtype=torch.float32) / 16
    np.testing.assert_array_equal(torch.stack(torch.meshgrid(i, i, indexing="ij"), -1).numpy(), make_2dcoord(16, 16))


def test_stock_table_is_jax_sincos_and_gta_has_none():
    from gta_tpu.models.dit import _sincos_pos_embed

    for g, d in ((16, 384), (4, 32)):
        np.testing.assert_array_equal(sincos_pos_embed(g, d), _sincos_pos_embed(g, d))
    assert "pos_embed" not in dict(DiT(dit_config_from_dict(_tiny_raw("gta")).model).named_buffers())


@pytest.mark.parametrize("path", PUBLISHED, ids=["dit_gta", "dit_base"])
def test_dit_config_from_dict_field_by_field(path):
    with open(path) as f:
        raw = yaml.safe_load(f)
    j, t = j_dit_config_from_dict(raw), load_dit_config(path)
    assert t == dit_config_from_dict(raw)
    for f in dataclasses.fields(t.model):
        if f.name != "attn":
            assert getattr(t.model, f.name) == getattr(j.model, f.name), f.name
    for f in dataclasses.fields(t.model.attn):
        if f.name == "gta":
            jg = dataclasses.asdict(j.model.attn.gta)
            assert {k: jg[k] for k in dataclasses.asdict(t.model.attn.gta)} == dataclasses.asdict(t.model.attn.gta)
        else:
            assert getattr(t.model.attn, f.name) == getattr(j.model.attn, f.name), f.name
    assert dataclasses.asdict(t.data) == dataclasses.asdict(j.data)
    for f in dataclasses.fields(t.training):
        assert getattr(t.training, f.name) == getattr(j.training, f.name), f.name
    assert t.seed == j.seed
    m = t.model
    assert (m.hidden_size, m.depth, m.heads, m.grid, m.num_classes, m.timesteps, m.learn_sigma) == (
        384, 12, 6, 16, 1000, 1000, True)
    assert t.training.mixed_prec and t.training.batch_size == 256


@pytest.mark.parametrize("size,classes,mode,seed", [(32, 1000, "train", 0), (16, 10, "val", 3), (8, 4, "test", 1)])
def test_synthetic_images_byte_equal(size, classes, mode, seed):
    t, j = SyntheticImages(size, classes, mode, 40, seed), JSyntheticImages(size, classes, mode, 40, seed)
    assert len(t) == len(j) == 40
    items = [(t[i], j[i]) for i in (0, 1, 17, 39)]
    for a, b in items:
        assert a["image"].dtype == b["image"].dtype and a["image"].tobytes() == b["image"].tobytes()
        assert a["label"].dtype == b["label"].dtype and a["label"] == b["label"]
    ta, ja = collate_images([a for a, _ in items]), j_collate_images([b for _, b in items])
    for k in ("image", "label"):
        assert ta[k].dtype == ja[k].dtype and ta[k].tobytes() == ja[k].tobytes()


def test_imagenet_reader_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        ImageNetTFDS(32, "train", "/nonexistent")


@pytest.mark.parametrize("classes", [10, 1000])
def test_stripe_classifier_matches_jax_and_is_exact(classes):
    ds = SyntheticImages(32, classes, "val", 120)
    batch = collate_images([ds[i] for i in range(120)])
    np.testing.assert_array_equal(stripe_classifier.class_templates(classes), j_stripe.class_templates(classes))
    np.testing.assert_array_equal(stripe_classifier.classify(batch["image"], classes),
                                  j_stripe.classify(batch["image"], classes))
    rng = np.random.RandomState(0)
    noise = rng.randn(16, 32, 32, 3).astype(np.float32)
    np.testing.assert_array_equal(stripe_classifier.classify(noise, classes), j_stripe.classify(noise, classes))
    acc, per = stripe_classifier.accuracy(batch["image"], batch["label"], classes)
    j_acc, j_per = j_stripe.accuracy(batch["image"], batch["label"], classes)
    assert acc == j_acc
    np.testing.assert_array_equal(per, j_per)
    if classes == 10:  # five frequencies: with 1000 classes neighbouring angles share an FFT peak
        assert acc == 1.0, (acc, per)


def test_port_dit_learns_and_samples():
    """The port's tiny GTA DiT fits a two-class toy distribution (class 0
    constant +0.5 images, class 1 -0.5) within 60 Adam steps, as
    tests/test_dit.py's JAX one does; the CFG + DDIM sampler gives finite
    images."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # 60 steps of tiny ops: intra-op threads of parallel test workers only contend
    try:
        _learns_and_samples()
    finally:
        torch.set_num_threads(threads)


def _learns_and_samples():
    cfg = dit_config_from_dict(_tiny_raw("gta")).model
    model = build_dit(cfg)
    sch = td.make_schedule(cfg.timesteps)
    rng = np.random.RandomState(1)
    y = torch.from_numpy(rng.randint(0, 2, 32))
    x0 = (0.5 - y.float())[:, None, None, None] * torch.ones((32, 8, 8, 3))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    first = None
    for _ in range(60):
        t = torch.randint(0, cfg.timesteps, (32,), generator=gen)
        noise = torch.randn(x0.shape, generator=gen)
        _, m = td.training_loss(sch, lambda xt, tt: model(xt, tt, y), x0, t, noise, True, 0.001)
        opt.zero_grad()
        m["loss"].backward()
        opt.step()
        first = m["mse"].item() if first is None else first
    assert m["mse"].item() < 0.7 * first, (first, m["mse"].item())
    fn = td.cfg_model_fn(lambda x, t, yy: model(x, t, yy), torch.tensor([0, 1]), cfg.null_label, 1.0)
    with torch.no_grad():
        out = td.ddim_sample(sch, fn, (2, 8, 8, 3), td.generator_randn(torch.Generator().manual_seed(2)), steps=5)
    assert out.shape == (2, 8, 8, 3) and torch.isfinite(out).all()


def test_trainer_step_evaluate_sample_and_state():
    """train_step's metrics (lr 0 on the first warmup step), evaluate's
    per-batch seeded draws, sample's clip and seed, and a state round trip
    that continues the generator where it stopped."""
    cfg = dit_config_from_dict(_tiny_raw("gta"))
    tr = DiTTrainer(cfg, device="cpu")
    ds = SyntheticImages(8, 4, "train", 16)
    batch = collate_images([ds[i] for i in range(4)])
    m = tr.train_step(batch)
    assert sorted(m) == ["grad_norm", "loss", "lr", "mse", "vb"] and m["lr"] == 0.0 and tr.step == 1
    assert all(torch.isfinite(m[k]) for k in ("loss", "mse", "vb", "grad_norm"))
    e1, e2 = tr.evaluate([batch, batch], seed=2), tr.evaluate([batch, batch], seed=2)
    assert e1 == e2 and sorted(e1) == ["loss", "mse", "vb"]
    s = tr.sample(np.array([0, 1, 3]), seed=4, steps=3)
    assert s.shape == (3, 8, 8, 3) and s.min() >= -1.0 and s.max() <= 1.0
    np.testing.assert_array_equal(s, tr.sample(np.array([0, 1, 3]), seed=4, steps=3))
    buf = io.BytesIO()
    torch.save(tr.state_dict(), buf)  # as the Checkpointer writes it: no tensor shared with `tr`
    buf.seek(0)
    other = DiTTrainer(cfg, device="cpu", seed=9)
    other.load_state_dict(torch.load(buf, weights_only=True))
    a, b = tr.train_step(batch), other.train_step(batch)
    assert other.step == 2 and a["loss"].item() == b["loss"].item()
    assert all(torch.equal(p, q) for p, q in zip(tr.model.parameters(), other.model.parameters()))


def test_dit_entry_points_need_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    from gta_tpu_torch import train_dit as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(_tiny_raw("gta")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiTTrainer(load_dit_config(str(path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(path), "--outdir", str(tmp_path / "run"), "--exit-after", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(path), "--outdir", str(tmp_path / "run"), "--exit-after", "0", "--device-data"])


@pytest.mark.parametrize("method", ["gta", ""], ids=["gta", "base"])
def test_cli_trains_resumes_and_evaluates_samples_on_cpu(tmp_path, capsys, method):
    """python -m gta_tpu_torch.train_dit on a shrunk yaml: the procedural
    fallback, a sample grid, metrics.jsonl, checkpoints and a resume; then
    python -m gta_tpu_torch.scripts.eval_dit_samples on the run."""
    from gta_tpu_torch import train_dit as cli
    from gta_tpu_torch.data.png import imread

    raw = _tiny_raw(method, print_every=1, validate_every=2, checkpoint_every=2, backup_every=3,
                    visualize_every=0, num_workers=2)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "run"
    base = [str(path), "--outdir", str(out), "--device", "cpu", "--max-eval", "4"]
    cli.main(base + ["--exit-after", "2", "--samplenow", "--sample-steps", "3"])
    first = capsys.readouterr().out
    assert "No ImageNet datapath — falling back to procedural images." in first
    assert "DiT parameters: " in first and "Sample grid written: samples_0.png" in first
    assert "it=2 loss=" in first and "Iteration limit reached" in first and "Resumed" not in first
    grid = imread(str(out / "samples_0.png"))
    assert grid.shape[0] == 8 and grid.shape[1] >= 4 * 8
    cli.main(base + ["--exit-after", "4"])
    second = capsys.readouterr().out
    assert "Resumed from checkpoint at it=3" in second and "it=4 eval:" in second
    for name in ("latest", "step_3"):
        assert Checkpointer(str(out)).exists(name)
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [(r["kind"], r["it"]) for r in logged] == [
        ("train", 0), ("train", 1), ("eval", 2), ("train", 2), ("train", 3), ("eval", 4), ("train", 4)]
    assert sorted(logged[2]) == ["it", "kind", "loss", "mse", "vb"]
    eval_dit_samples.main([str(path), "--outdir", str(out), "--per-class", "2", "--steps", "3", "--max-eval", "16",
                           "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Loaded latest at it=5"
    result = json.loads(lines[1])
    assert sorted(result) == sorted(["config", "it", "per_class_n", "sample_class_accuracy", "per_class_accuracy",
                                     "per_class_eval_loss", "eval_loss_mean", "steps", "guidance"])
    assert result["it"] == 5 and result["per_class_n"] == 2 and len(result["per_class_accuracy"]) == 4
    assert 0.0 <= result["sample_class_accuracy"] <= 1.0 and np.isfinite(result["eval_loss_mean"])
    assert json.loads((out / "dit_sample_eval.json").read_text()) == result
