"""The model options no published config reaches, in the port against the
JAX package on the CPU: the encoder's and decoder's `planar` and
`camera_planar` embeddings, and the decoder's `return_last_attmap`.

  * planar / camera_planar: the flagship (runs/clevrtr/GTA/gta) shrunk as
    tests/test_torch_train.py shrinks it (2 heads of 64, one block a side,
    32x48 inputs, dropout 0) with the embedding in encoder and decoder, the
    JAX init carried over by params_from_jax. fp32: pixels within 1e-5
    relative L2 of JAX's, the loss within 1e-5 (relative), every gradient
    tensor within 1e-4 relative L2. bf16 (camera_planar, mixed_prec, both
    frameworks on their attention kernels: JAX's Pallas kernels in
    interpret mode, GELU rounded once, as tests/test_torch_bf16.py runs
    them): the port's pixels at most BF16_RULE (1.5) times as far (relative
    L2) from JAX's fp32 pixels as JAX's bf16 pixels are.
  * return_last_attmap: tests/test_attmap.py's config (plain attention, a
    one-head decoder) and a GTA one (the flagship's attention, two decoder
    blocks): the decoder's masks [B, Tq, Tk] and pixels against JAX's
    within 1e-6 (atol), masks summing to 1 over the keys; every decoder
    block routes to torch eager (never flash_core, the fused GTA kernels or
    the ring, as JAX keeps such a module off them) while the encoder keeps
    its kernels, and the trainer's eval_step runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gta_tpu_torch.models.layers as t_layers
from gta_tpu.config import AttnConfig as JAttnConfig, DecoderConfig as JDecoderConfig, \
    EncoderConfig as JEncoderConfig, ModelConfig as JModelConfig, load_config as j_load_config
from gta_tpu.data.synthetic import SyntheticScenes as JSyntheticScenes, collate as j_collate
from gta_tpu.models.srt import build_model as j_build_model
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch.config import AttnConfig, DataConfig, DecoderConfig, EncoderConfig, ModelConfig, load_config, \
    with_ring_attention
from gta_tpu_torch.data.synthetic import collate
from gta_tpu_torch.models.srt import build_model
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import params_from_jax
from tests.test_models import tiny_data_cfg
from tests.test_torch_bf16 import _jit_rounding_each_op, _tpu_numerics
from tests.test_torch_train import _items, _train_cfg

FLAGSHIP = "runs/clevrtr/GTA/gta/config.yaml"
FWD_RTOL, GRAD_RTOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
BF16_RULE = 1.5
MAP_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: intra-op threads only contend with the parallel test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _with_emb(cfg, emb, **training):
    m = cfg.model
    model = dataclasses.replace(m, encoder=dataclasses.replace(m.encoder, emb=emb),
                                decoder=dataclasses.replace(m.decoder, emb=emb))
    return dataclasses.replace(cfg, model=model, training=dataclasses.replace(cfg.training, **training))


def _jbatch(items):
    return jax.tree.map(jnp.asarray, j_collate(items))


@pytest.mark.parametrize("emb", ["planar", "camera_planar"])
def test_planar_embeddings_match_jax_fp32(emb):
    jtr = JTrainer(_with_emb(_train_cfg(j_load_config(FLAGSHIP)), emb))
    cfg = _with_emb(_train_cfg(load_config(FLAGSHIP)), emb)
    items = _items(cfg, (0, 1))
    params = jtr.init_state(_jbatch(items), seed=0).params
    ttr = Trainer(cfg, device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    enc, dec = ttr.model.encoder, ttr.model.decoder.allocation_transformer
    assert dec.input_mlp[0].in_features == (192 if emb == "camera_planar" else 180)
    assert enc.conv_blocks[0].layers[0].in_channels == (3 if emb == "camera_planar" else 183)
    assert hasattr(enc, "lin_planar") == hasattr(enc, "lin_camera") == (emb == "camera_planar")

    want_px, _ = jax.jit(lambda p, b: jtr.model.apply(p, b, deterministic=True))(params, _jbatch(items))
    with torch.no_grad():
        got_px, _ = ttr.model(collate(items))
    assert _gap(got_px.numpy(), want_px) <= FWD_RTOL

    items = _items(cfg, (2, 3))
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        params, _jbatch(items), jax.random.PRNGKey(0))
    loss, _, _ = ttr.loss_and_grads(collate(items))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {name: p.grad for name, p in ttr.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert _gap(g.numpy(), want[name].numpy()) <= GRAD_RTOL, name


def test_camera_planar_bf16_meets_the_tpu_rounding_rule():
    path = FLAGSHIP
    jcfg = {mp: _with_emb(_train_cfg(j_load_config(path)), "camera_planar", mixed_prec=mp, flash="fused")
            for mp in (False, True)}
    tcfg = _with_emb(_train_cfg(load_config(path)), "camera_planar", mixed_prec=True)
    items = _items(tcfg, (0, 1))
    jtr = {mp: JTrainer(c) for mp, c in jcfg.items()}
    assert all(t.cfg.model.encoder.attn.fused for t in jtr.values())
    params = jtr[False].init_state(_jbatch(items), seed=0).params
    with pytest.MonkeyPatch.context() as patch:
        _tpu_numerics(patch)
        px = {mp: np.asarray(_jit_rounding_each_op(lambda p, b, m=jtr[mp].model: m.apply(p, b, deterministic=True)[0],
                                                   params, _jbatch(items)), np.float32) for mp in (False, True)}
    ttr = Trainer(tcfg, device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got, _ = ttr.model(collate(items))
    assert got.dtype == torch.float32
    jax_gap = _gap(px[True], px[False])
    assert jax_gap > 1e-4  # bf16 really moves the pixels
    assert _gap(got.numpy(), px[False]) <= BF16_RULE * jax_gap, (_gap(got.numpy(), px[False]), jax_gap)


PLAIN = dict(method="")
GTA = "flagship"  # the flagship's attention config, on both sides


def _attmap_cfgs(attn, dec_blocks):
    """tests/test_attmap.py's ModelConfig for both frameworks, with `attn`
    ('' or the flagship's GTA) and `dec_blocks` decoder blocks."""
    out = []
    for pkg_load, Attn, Enc, Dec, Model in ((j_load_config, JAttnConfig, JEncoderConfig, JDecoderConfig, JModelConfig),
                                            (load_config, AttnConfig, EncoderConfig, DecoderConfig, ModelConfig)):
        if attn == GTA:
            flagship = pkg_load(FLAGSHIP).model
            enc_attn, dec_attn = flagship.encoder.attn, flagship.decoder.attn
            dims = dict(attdim=128, heads=2), dict(dim=48, z_dim=128, dim_head=64)
        else:
            enc_attn = dec_attn = Attn(**attn)
            dims = dict(attdim=64, heads=2), dict(dim=48, z_dim=64)
        out.append(Model(
            model_type="tsrt",
            encoder=Enc(dim=128, num_att_blocks=1, emb="ray", attn=enc_attn, **dims[0]),
            decoder=Dec(heads=1, rmlp_dim=64, num_att_blocks=dec_blocks, emb="ray", attn=dec_attn,
                        return_last_attmap=True, **dims[1]),
        ))
    return out


@pytest.mark.parametrize("attn,dec_blocks", [(PLAIN, 1), (GTA, 2)], ids=["plain", "gta"])
def test_return_last_attmap_matches_jax(attn, dec_blocks, monkeypatch):
    jcfg, tcfg = _attmap_cfgs(attn, dec_blocks)
    ds = JSyntheticScenes(tiny_data_cfg(), "train", num_scenes=2, use_native=False)
    items = [ds[0], ds[1]]
    jmodel = j_build_model(jcfg)
    params = jax.jit(lambda key, b: jmodel.init(key, b, deterministic=True))(jax.random.PRNGKey(0), _jbatch(items))
    want_px, want_aux = jax.jit(lambda p, b: jmodel.apply(p, b, deterministic=True))(params, _jbatch(items))

    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    routes = {side: [layer[0].fn.route() for layer in getattr(model, side).transformer.layers]
              for side in ("encoder",)}
    routes["decoder"] = [layer[0].fn.route() for layer in model.decoder.allocation_transformer.transformer.layers]
    assert routes["decoder"] == ["eager"] * dec_blocks
    assert routes["encoder"] == ["gta" if attn == GTA else "flash"]
    calls = {"flash": 0, "gta": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(t_layers, "flash_attention", counted("flash", t_layers.flash_attention))
    monkeypatch.setattr(t_layers, "fused_gta_attention", counted("gta", t_layers.fused_gta_attention))
    with torch.no_grad():
        got_px, aux = model(collate(items))
    assert calls == {"flash": 0 if attn == GTA else 1, "gta": 1 if attn == GTA else 0}  # the encoder's block alone

    masks = aux["masks"].numpy()
    want = np.asarray(want_aux["masks"])
    assert masks.shape == want.shape == (2, got_px.shape[1], want.shape[2])
    np.testing.assert_allclose(masks, want, atol=MAP_ATOL)
    np.testing.assert_allclose(masks.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=MAP_ATOL)

    # the ring leaves the module that returns its map alone, as JAX's does
    full = dataclasses.replace(load_config(FLAGSHIP), model=tcfg)
    ringed = with_ring_attention(full).model
    assert ringed.encoder.attn.ring == (attn == GTA) and not ringed.decoder.attn.ring


def test_trainer_runs_a_return_last_attmap_model():
    """eval_step and a train step (JAX's trainer drops the masks as the
    port's does)."""
    _, tcfg = _attmap_cfgs(PLAIN, 1)
    data = DataConfig(dataset="synthetic", num_points=96, height=32, width=32, downsample=0,
                      downsample_input_coord=3, num_input_views=2, num_target_views=2, num_views=5)
    ttr = Trainer(dataclasses.replace(load_config(FLAGSHIP), model=tcfg, data=data), device="cpu")
    batch = collate(_items(ttr.cfg, (0, 1)))
    assert np.isfinite(ttr.eval_step(batch)["psnr"].numpy()).all()
    assert np.isfinite(float(ttr.train_step(batch)["loss"]))
