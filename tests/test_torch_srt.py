"""The port's SRT baseline (runs/clevrtr/otherPEs/srt) against the JAX
package, serving and training, on the CPU.

The SRT baseline is the CLEVR-TR comparison point of the GTA paper: plain
softmax attention (method '') in every layer, `ray` input embeddings on
both sides (the decoder's through the input MLP) and non-transform batches
(flat [B, P, 3] target rays, no target transforms). Both models are built
from its YAML shrunk as tests/test_torch_models.py shrinks the flagship
(2 heads of 64 channels, one attention block each side, 32x48 inputs,
48 target rays), with dropout 0: the two frameworks draw different dropout
bits. The JAX params carry over with `params_from_jax`. The JAX CPU trainer
runs its XLA attention path (`flash: auto` is off on the CPU), which
computes the same function as its flash_core kernel; the kernel-level
comparison is in tests/test_torch_flash_core.py.

Tolerances as for the flagship: pixels and PSNR atol 1e-4; one step's
gradients atol 5e-5 / rtol 1e-3; params after two steps atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.train.trainer import Trainer as JTrainer, TrainState
from gta_tpu.utils.ref_import import flax_path_to_torch_key as j_flax_path_to_torch_key
from gta_tpu_torch import evaluate as t_evaluate
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.train import __main__ as t_train
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import flax_path_to_torch_key, params_from_jax
from tests.test_torch_train import _assert_params_close, _items, _tiny_yaml, _train_cfg
from tests.test_torch_train import _pair as _train_pair

SRT = "runs/clevrtr/otherPEs/srt/config.yaml"
ATOL = 1e-4


def _jbatch(items):
    return jax.tree.map(jnp.asarray, j_collate(items))


@pytest.fixture(scope="module")
def j_params():
    """The shrunk SRT model's JAX init params (seed 0)."""
    cfg = _train_cfg(load_config(SRT))
    jtr = JTrainer(_train_cfg(j_load_config(SRT)))
    return jtr.init_state(_jbatch(_items(cfg, (0, 1))), seed=0).params


def _pair(params, **training):
    return _train_pair(params, SRT, **training)


def test_config_is_the_srt_baseline():
    cfg = load_config(SRT)
    enc, dec = cfg.model.encoder, cfg.model.decoder
    assert cfg.model.model_type == "srt" and not cfg.data.return_transform
    assert (enc.attn.method, dec.attn.method, enc.emb, dec.emb) == ("", "", "ray", "ray")
    assert (enc.attdim // enc.heads, dec.head_dim, enc.heads, dec.heads) == (64, 64, 6, 6)
    item = _items(cfg, (0,))[0]
    assert "target_transforms" not in item and item["target_rays"].shape == (cfg.data.num_points, 3)


def test_key_map_matches_reference_map(j_params):
    _, _, ttr, _ = _pair(j_params)
    flat = jax.tree_util.tree_flatten_with_path(j_params["params"])[0]
    keys = [tuple(k.key for k in path) for path, _ in flat]
    assert any("input_mlp0" in k for k in keys) and any("input_mlp1" in k for k in keys)
    for k in keys:
        assert flax_path_to_torch_key(k) == j_flax_path_to_torch_key(k)
    state = ttr.model.state_dict()
    assert sorted(params_from_jax(j_params)) == sorted(state)
    assert state["encoder.conv_blocks.0.layers.0.weight"].shape[1] == 183  # RGB + 180 ray-PE channels


def test_eval_step_matches_jax(j_params):
    jtr, state, ttr, cfg = _pair(j_params)
    items = _items(cfg, (2, 3), "val")
    want = jtr.eval_step(state.params, _jbatch(items))
    got = ttr.eval_step(collate(items))
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), atol=ATOL)
    np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(want["psnr"]), atol=ATOL)
    want_px, _ = jtr.model.apply(state.params, _jbatch(items), deterministic=True)
    with torch.no_grad():
        got_px, _ = ttr.model(collate(items))
    assert got_px.shape == (2, cfg.data.num_points, 3)
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=ATOL)


def test_render_rays_and_render_image_match_jax(j_params):
    """render_rays on an item's flat target rays (chunked with a padded
    last chunk), and the non-transform render_image of a novel camera, whose
    ray grid comes from the camera's extrinsic."""
    jtr, state, ttr, cfg = _pair(j_params)
    items = _items(cfg, (0,), "test")
    jbatch, batch = _jbatch(items), collate(items)
    rays, cam = batch.target_rays.numpy(), batch.target_camera_pos.numpy()
    want = jtr.render_rays(state.params, jbatch, rays, cam, chunk=32)
    got = ttr.render_rays(batch, rays, cam, chunk=32)
    assert got.shape == (1, cfg.data.num_points, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)

    ext = items[0]["input_transforms"][None, 1]  # the second input view's camera
    want = jtr.render_image(state.params, jbatch, 32, 48, target_transform=ext, chunk=512)
    got = ttr.render_image(batch, 32, 48, target_transform=ext, chunk=512)
    assert got.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_loss_and_grads_match_jax(j_params):
    jtr, state, ttr, cfg = _pair(j_params)
    items = _items(cfg, (2, 3))
    (j_loss, j_mse), j_grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        state.params, _jbatch(items), jax.random.PRNGKey(0)
    )
    loss, mse, _ = ttr.loss_and_grads(collate(items))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(mse.numpy(), np.asarray(j_mse), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {name: p.grad for name, p in ttr.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-3, err_msg=name)


def test_two_train_steps_match_jax(j_params):
    jtr, state, ttr, cfg = _pair(j_params, lr_warmup=2)
    rng = jax.random.PRNGKey(0)
    for step, idx in enumerate([(0, 1), (2, 3)]):
        items = _items(cfg, idx)
        state, want = jtr.train_step(state, _jbatch(items), rng)
        got = ttr.train_step(collate(items))
        for key in ("loss", "mse", "lr", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=f"step {step} {key}")
    assert ttr.step == int(state.step) == 2
    _assert_params_close(ttr, state.params, atol=1e-5)


def test_cli_trains_two_steps_on_cpu(tmp_path, capsys):
    cfg = _tiny_yaml(tmp_path, SRT)
    t_train.main([cfg, "--synthetic", "--outdir", str(tmp_path / "run"), "--device", "cpu", "--exit-after", "1"])
    out = capsys.readouterr().out
    assert "it=0, loss=" in out and "it=1, loss=" in out and "Iteration limit reached" in out


def test_evaluate_cli_matches_jax_render_rays(j_params, tmp_path, capsys):
    """`python -m gta_tpu_torch.evaluate --device cpu` on one full-scale
    scene (64x96 targets from 32x48 inputs) with the JAX weights: each
    target view's PSNR through the port's render_rays equals the JAX
    trainer's on the same rays."""
    path = _tiny_yaml(tmp_path, SRT)
    ckpt = tmp_path / "model.pt"
    torch.save(params_from_jax(jax.tree.map(np.asarray, j_params)), ckpt)
    got = t_evaluate.main([path, "--synthetic", "--device", "cpu", "--max-scenes", "1", "--state-dict", str(ckpt),
                            "--outdir", str(tmp_path / "eval")])
    assert got["n_scenes"] == 1 and got["device"] == "cpu"

    cfg = load_config(path)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))
    test = SyntheticScenes(cfg.data, "test", full_scale=True)
    item = test[0]
    jtr = JTrainer(_train_cfg(j_load_config(SRT)))
    n = test.target_h * test.target_w
    psnrs = []
    for v in range(item["target_rays"].shape[0] // n):
        sl = slice(v * n, (v + 1) * n)
        pred = jtr.render_rays(j_params, _jbatch([item]), item["target_rays"][None, sl],
                               item["target_camera_pos"][None, sl], chunk=16384)
        psnrs.append(-10.0 * np.log10(np.mean((pred - item["target_pixels"][None, sl]) ** 2)))
    assert len(psnrs) == cfg.data.num_target_views
    np.testing.assert_allclose(got["psnr"], np.mean(psnrs), atol=ATOL)
