"""The port's evaluation slice against the JAX package, on the CPU.

- SSIM (`gta_tpu_torch.utils.metrics.ssim`) against `gta_tpu.utils.metrics.ssim`
  on the four pairs of tests/test_metric_goldens.py and random frames
  (atol 1e-5), and against `tf.image.ssim` (2e-3, as the JAX golden);
- LPIPS-VGG (`gta_tpu_torch.utils.lpips`) against
  `gta_tpu.utils.lpips_jax.lpips_distance` on the same random weights
  (rtol 1e-4, atol 1e-6, as tests/test_metrics.py), the npz round trip and
  the missing-weights error;
- the render grid: `colorize_clusters` and `checkerboard_composite` equal to
  the JAX package's, and the PNG decoding back to the grid array;
- `Trainer.visualize` on the shrunk flagship and SRT models with the JAX
  weights (`params_from_jax`): the columns each side hands its grid writer,
  within the fp32 pixel tolerance 1e-4;
- the CLIs: a checkpoint written by the port's train CLI, restored by
  `evaluate --ckpt best`, scores the PSNR, SSIM and LPIPS that the JAX
  trainer's render_image and metrics give on the same weights; an absent
  checkpoint evaluates the random init; `--visnow` and `visualize_every`
  write renders-val.png.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu.utils import lpips_jax as j_lpips
from gta_tpu.utils import metrics as j_metrics
from gta_tpu.utils import visualize as j_visualize
from gta_tpu.utils.ref_import import flax_path_to_torch_key as j_flax_path_to_torch_key
from gta_tpu_torch import evaluate as t_evaluate
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.train import __main__ as t_train
from gta_tpu_torch.train import trainer as t_trainer
from gta_tpu_torch.train.checkpoint import Checkpointer
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.utils import lpips, metrics, visualize
from gta_tpu_torch.weights import params_from_jax
from tests.test_torch_models import FLAGSHIP
from tests.test_torch_srt import SRT
from tests.test_torch_train import _items, _tiny_yaml, _train_cfg
from tests.test_torch_train import _pair as _train_pair

PX_ATOL = 1e-4  # fp32 pixels across frameworks (reduction order differs)


def _pairs():
    """The four pairs of tests/test_metric_goldens.py (that module imports
    TensorFlow when it is imported): noisy, shifted, blurred, identical."""
    rng = np.random.RandomState(0)
    clean = rng.rand(2, 48, 64, 3).astype(np.float32)
    noisy = np.clip(clean + rng.normal(scale=0.08, size=clean.shape), 0, 1).astype(np.float32)
    smooth = np.broadcast_to(np.linspace(0, 1, 64, dtype=np.float32)[None, None, :, None], clean.shape).copy()
    smooth_shift = np.clip(smooth + 0.05, 0, 1).astype(np.float32)
    blur = clean.copy()
    blur[:, 1:] = 0.5 * (blur[:, 1:] + blur[:, :-1])
    return [(clean, noisy), (smooth, smooth_shift), (clean, blur), (clean, clean)]


def _frames():
    """The golden pairs, then two random pairs of other sizes."""
    rng = np.random.RandomState(11)
    a = rng.rand(1, 40, 56, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    c = rng.rand(3, 24, 24, 3).astype(np.float32)
    return _pairs() + [(a, b), (c, rng.rand(3, 24, 24, 3).astype(np.float32))]


@pytest.mark.parametrize("idx", range(6))
def test_ssim_matches_jax(idx):
    a, b = _frames()[idx]
    got = metrics.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == ()
    want = float(j_metrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got.item() - want) <= 1e-5, (got.item(), want)


@pytest.mark.parametrize("idx", range(4))
def test_ssim_matches_tf_golden(idx):
    pytest.importorskip("tensorflow")
    from tests.test_metric_goldens import _pairs as golden_pairs, _tf_ssim

    a, b = _pairs()[idx]
    np.testing.assert_array_equal(a, golden_pairs()[idx][0])
    np.testing.assert_array_equal(b, golden_pairs()[idx][1])
    got = metrics.ssim(torch.from_numpy(a), torch.from_numpy(b)).item()
    golden = _tf_ssim(a, b)
    assert abs(got - golden) < 2e-3, (got, golden)


def test_ssim_identity_bf16_input_and_psnr():
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.rand(2, 32, 40, 3).astype(np.float32))
    assert metrics.ssim(a, a).item() == pytest.approx(1.0, abs=1e-6)
    # bf16 images are scored in fp32
    assert metrics.ssim(a.bfloat16(), a.bfloat16()).dtype == torch.float32
    b = torch.clamp(a + 0.05, 0, 1)
    np.testing.assert_allclose(
        metrics.psnr(a, b).item(), float(j_metrics.psnr(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))), rtol=1e-5
    )
    np.testing.assert_array_equal(metrics._gaussian_kernel(), j_metrics._gaussian_kernel())


def test_lpips_constants_and_random_params_equal_jax():
    for name in ("VGG16_CONVS", "POOL_BEFORE", "STAGE_AFTER_CONV"):
        assert getattr(lpips, name) == getattr(j_lpips, name), name
    np.testing.assert_array_equal(lpips.SHIFT, j_lpips.SHIFT)
    np.testing.assert_array_equal(lpips.SCALE, j_lpips.SCALE)
    got, want = lpips.random_params(np.random.RandomState(0)), j_lpips.random_params(np.random.RandomState(0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shape", [(2, 32, 32), (1, 48, 72)])
def test_lpips_matches_jax(shape):
    rng = np.random.RandomState(2)
    a = rng.rand(*shape, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*shape, 3).astype(np.float32), 0, 1)
    net = lpips.VGG16LPIPS.from_params(lpips.random_params(np.random.RandomState(2)))
    got = lpips.lpips_distance(torch.from_numpy(a), torch.from_numpy(b), net)
    params = {k: jnp.asarray(v) for k, v in j_lpips.random_params(np.random.RandomState(2)).items()}
    want = np.asarray(j_lpips.lpips_distance(jnp.asarray(a), jnp.asarray(b), params))
    assert got.shape == (shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    assert (got > 0).all()


def test_lpips_identity_is_zero():
    rng = np.random.RandomState(3)
    net = lpips.VGG16LPIPS.from_params(lpips.random_params(rng))
    a = torch.from_numpy(rng.rand(1, 32, 32, 3).astype(np.float32))
    np.testing.assert_allclose(lpips.lpips_distance(a, a, net).numpy(), 0.0, atol=1e-8)


def test_lpips_npz_round_trip_and_missing_weights(tmp_path, monkeypatch):
    params = lpips.random_params(np.random.RandomState(5))
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **params)
    rng = np.random.RandomState(6)
    a = rng.rand(2, 32, 48, 3).astype(np.float32)
    b = rng.rand(2, 32, 48, 3).astype(np.float32)
    want = float(np.mean(np.asarray(j_lpips.LPIPSJax(path)(a, b))))
    np.testing.assert_allclose(lpips.LPIPSVGG(path)(a, b), want, rtol=1e-4, atol=1e-6)
    monkeypatch.setenv("LPIPS_WEIGHTS", path)
    np.testing.assert_allclose(lpips.LPIPSVGG()(a, b), want, rtol=1e-4, atol=1e-6)
    with pytest.raises(RuntimeError, match="LPIPS weights not found"):
        lpips.LPIPSVGG(str(tmp_path / "absent.npz"))
    monkeypatch.delenv("LPIPS_WEIGHTS")
    with pytest.raises(RuntimeError, match="LPIPS weights not found"):
        lpips.LPIPSVGG()


def test_colorize_and_checkerboard_equal_jax():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 40, size=(2, 9, 13))
    np.testing.assert_array_equal(visualize.colorize_clusters(ids), j_visualize.colorize_clusters(ids))
    rgba = rng.rand(2, 20, 27, 4).astype(np.float32)
    for square in (8, 5):
        got = visualize.checkerboard_composite(rgba, square)
        want = j_visualize.checkerboard_composite(rgba, square)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_grid_png_decodes_to_the_grid(tmp_path):
    rng = np.random.RandomState(8)
    columns = [
        ("input 1", rng.rand(3, 10, 14, 3).astype(np.float32) * 1.4 - 0.2),  # clipped to [0, 1]
        ("render 60°", rng.rand(3, 10, 14, 4).astype(np.float32)),  # RGBA over the board
        ("slots", rng.randint(0, 12, size=(3, 10, 14)), "clustering"),
    ]
    path = str(tmp_path / "grid")
    grid = visualize.draw_visualization_grid(columns, path)
    gap = visualize.GAP
    assert grid.shape == (3 * (10 + gap) - gap, 3 * (14 + gap) - gap, 3) and grid.dtype == np.uint8
    cell = grid[10 + gap : 20 + gap, 14 + gap : 28 + gap]  # row 1, column 1
    want = np.round(np.clip(j_visualize.checkerboard_composite(columns[1][1])[1], 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(cell, want)
    np.testing.assert_array_equal(grid[:10, :14], np.round(np.clip(columns[0][1][0], 0, 1) * 255))
    assert (grid[10 : 10 + gap] == 255).all()
    decoded, text = visualize.read_png(path + ".png")
    np.testing.assert_array_equal(decoded, grid)
    assert text == {"Columns": "input 1 | render 60° | slots"}
    from PIL import Image  # an independent decoder

    with Image.open(path + ".png") as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), grid)


def _jax_and_port(path):
    """(JAX trainer, JAX params, port trainer with the same weights, cfg) of
    the model at `path`, shrunk as tests/test_torch_train.py shrinks it."""
    cfg = _train_cfg(load_config(path))
    jtr = JTrainer(_train_cfg(j_load_config(path)))
    params = jtr.init_state(jax.tree.map(jnp.asarray, j_collate(_items(cfg, (0, 1)))), seed=0).params
    _, _, ttr, cfg = _train_pair(params, path)
    return jtr, params, ttr, cfg


@pytest.mark.parametrize("path", [FLAGSHIP, SRT], ids=["gta", "srt"])
def test_visualize_columns_match_jax(path, monkeypatch):
    jtr, params, ttr, cfg = _jax_and_port(path)
    items = _items(cfg, (0, 1), mode="val")
    handed = {}
    monkeypatch.setattr(j_visualize, "draw_visualization_grid", lambda cols, p: handed.setdefault("jax", (cols, p)))
    monkeypatch.setattr(t_trainer, "draw_visualization_grid", lambda cols, p: handed.setdefault("port", (cols, p)))
    jtr.visualize(params, jax.tree.map(jnp.asarray, j_collate(items)), "out/renders-val", num_angles=3)
    ttr.visualize(collate(items), "out/renders-val", num_angles=3)
    (want, want_path), (got, got_path) = handed["jax"], handed["port"]
    assert got_path == want_path == "out/renders-val"
    assert [c[0] for c in got] == [c[0] for c in want] == ["input 1", "input 2", "render 0°", "render 120°",
                                                           "render 240°"]
    for (title, g), (_, w) in zip(got, want):
        assert g.shape == np.asarray(w).shape == (2, cfg.data.height, cfg.data.width, 3), title
        np.testing.assert_allclose(g, np.asarray(w), atol=PX_ATOL, err_msg=title)
    assert not ttr.model.training


def _jax_params_from_port(template, state):
    """The JAX params tree `template` with every leaf taken from the port's
    state_dict `state` (the inverse of `params_from_jax`)."""

    def leaf(path, _):
        names = tuple(p.key for p in path)
        names = names[1:] if names[0] == "params" else names
        v = state[j_flax_path_to_torch_key(names)].numpy()
        if names[-1] == "kernel":  # Linear [out, in] -> Dense [in, out]; OIHW -> HWIO
            v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(leaf, template)


def test_evaluate_restores_best_from_the_train_cli_and_matches_jax(tmp_path, monkeypatch, capsys):
    """The port's train CLI writes <run>/ckpts/best; `evaluate --ckpt best
    --outdir <run>` (init seed 1, so a missed restore shows) scores each
    full-scale view (64x96 from 32x48 inputs) as the JAX trainer's
    render_image, ssim and lpips_distance do on the same weights."""
    path = _tiny_yaml(tmp_path)
    run = str(tmp_path / "run")
    t_train.main([path, "--synthetic", "--outdir", run, "--device", "cpu", "--max-eval", "2", "--exit-after", "1",
                  "--evalnow"])
    assert Checkpointer(run).exists("best")
    lp_path = str(tmp_path / "lpips_vgg.npz")
    np.savez(lp_path, **lpips.random_params(np.random.RandomState(0)))
    monkeypatch.setenv("LPIPS_WEIGHTS", lp_path)
    capsys.readouterr()
    got = t_evaluate.main([path, "--synthetic", "--device", "cpu", "--max-scenes", "1", "--outdir", run,
                           "--ckpt", "best", "--seed", "1"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint best" in out and "WARNING" not in out
    assert list(got) == ["psnr", "ssim", "mse", "n_scenes", "lpips_vgg", "device", "dtype", "ckpt"]
    assert got["n_scenes"] == 1 and got["device"] == "cpu" and got["dtype"] == "float32" and got["ckpt"] == "best"
    with open(os.path.join(run, "eval_results.json")) as f:
        assert json.load(f) == got

    state = torch.load(os.path.join(run, "ckpts", "best", "state.pt"), map_location="cpu", weights_only=True)
    jcfg = j_load_config(path)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, dataset="synthetic"))
    jtr = JTrainer(jcfg)
    tcfg = load_config(path)
    test = SyntheticScenes(dataclasses.replace(tcfg.data, dataset="synthetic"), "test", full_scale=True)
    item = test[0]
    jbatch = jax.tree.map(jnp.asarray, j_collate([item]))
    params = _jax_params_from_port(jtr.init_state(jbatch, seed=0).params, state["model"])
    for k, v in params_from_jax(jax.tree.map(np.asarray, params)).items():
        assert torch.equal(v, state["model"][k]), k
    lp = {k: jnp.asarray(v) for k, v in j_lpips.random_params(np.random.RandomState(0)).items()}
    h, w = test.target_h, test.target_w
    psnrs, ssims, lps = [], [], []
    for v in range(item["target_transforms"].shape[0]):
        pred = jtr.render_image(params, jbatch, h, w, target_transform=item["target_transforms"][None, v],
                                chunk=16384, rays=item["target_rays"][None, v], cam=item["target_camera_pos"][None, v])
        gt = item["target_pixels"][v].reshape(1, h, w, 3)
        psnrs.append(-10.0 * np.log10(np.mean((pred - gt) ** 2)))
        ssims.append(float(j_metrics.ssim(jnp.asarray(pred), jnp.asarray(gt))))
        lps.append(float(jnp.mean(j_lpips.lpips_distance(jnp.asarray(pred), jnp.asarray(gt), lp))))
    np.testing.assert_allclose(got["psnr"], np.mean(psnrs), atol=PX_ATOL)
    np.testing.assert_allclose(got["ssim"], np.mean(ssims), atol=PX_ATOL)
    np.testing.assert_allclose(got["lpips_vgg"], np.mean(lps), rtol=1e-4, atol=1e-6)


def test_evaluate_without_the_checkpoint_scores_the_random_init(tmp_path, monkeypatch, capsys):
    """An absent checkpoint: the JAX WARNING, the init from --seed, PSNR /
    SSIM / MSE only without LPIPS weights, eval_results.json in --outdir, and
    no ckpts/ directory created."""
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    path = _tiny_yaml(tmp_path)
    out_dir = tmp_path / "eval"
    got = t_evaluate.main([path, "--synthetic", "--device", "cpu", "--max-scenes", "1", "--outdir", str(out_dir),
                           "--seed", "3"])
    out = capsys.readouterr().out
    assert f"WARNING: checkpoint 'best' not found in {out_dir}/ckpts" in out and "LPIPS unavailable" in out
    assert list(got) == ["psnr", "ssim", "mse", "n_scenes", "device", "dtype", "ckpt"] and got["ckpt"] is None
    assert sorted(os.listdir(out_dir)) == ["eval_results.json"]

    cfg = load_config(path)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))
    trainer = Trainer(cfg, device="cpu", seed=3)
    test = SyntheticScenes(cfg.data, "test", full_scale=True)
    batch = collate([test[0]])
    h, w = test.target_h, test.target_w
    ssims = []
    for v in range(batch.target_transforms.shape[1]):
        pred = trainer.render_image(batch, h, w, target_transform=batch.target_transforms[:, v].numpy(), chunk=16384,
                                    rays=batch.target_rays[:, v].numpy(), cam=batch.target_camera_pos[:, v].numpy())
        gt = batch.target_pixels[:, v].reshape(1, h, w, 3)
        ssims.append(metrics.ssim(torch.from_numpy(pred), gt).item())
    np.testing.assert_allclose(got["ssim"], np.mean(ssims), atol=1e-6)


@pytest.mark.parametrize("how", ["visnow", "visualize_every"])
def test_train_cli_writes_the_render_grid(tmp_path, capsys, how):
    """--visnow renders at the first step; `visualize_every: 1` at every step
    after it. The grid: min(6, batch 2) rows, 2 input and 6 render columns
    of 32x48 (the downsampled input resolution)."""
    path = _tiny_yaml(tmp_path)
    if how == "visualize_every":
        text = open(path).read()
        assert "visualize_every: 10000" in text
        with open(path, "w") as f:
            f.write(text.replace("visualize_every: 10000", "visualize_every: 1"))
    run = str(tmp_path / "run")
    extra = ["--visnow"] if how == "visnow" else []
    t_train.main([path, "--synthetic", "--outdir", run, "--device", "cpu", "--max-eval", "2", "--exit-after", "1"]
                 + extra)
    out = capsys.readouterr().out
    assert out.count("Visualizing...") == 1
    before, after = out.split("Visualizing...")
    assert ("it=0, loss=" in before) == (how == "visualize_every")
    grid, text = visualize.read_png(os.path.join(run, "renders-val.png"))
    gap = visualize.GAP
    assert grid.shape == (2 * (32 + gap) - gap, 8 * (48 + gap) - gap, 3)
    assert text["Columns"].split(" | ") == ["input 1", "input 2"] + [f"render {a}°" for a in range(0, 360, 60)]
