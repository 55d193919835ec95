"""Synthetic scenes made on the device (gta_tpu_torch/data/device_synth.py)
against gta_tpu/data/device_synth.py, on the CPU at small shapes:

  * the camera functions and the renderer on the same numpy inputs as the
    JAX package's (extrinsics 1e-6, images 1e-5), and the renderer
    against the port's host renderer (data/synthetic._render, 2e-5);
  * the batches: geometry self-consistency, sampled target pixels equal
    to the full-scale frames (transform and non-transform branches), val
    ids disjoint from train ids, a flagship train step on them;
  * a scene depends only on (seed, mode, id): a batch split over two
    shards is the whole batch bit for bit, a repeated call is the same
    bits, the next step differs. JAX's keys are not reproduced, so the
    draws are held to JAX's by their statistics over 64 scenes;
  * the train CLI with --synthetic --device-data: a resumed run feeds the
    scene ids and takes the loss of an unbroken one, and two gloo ranks
    (this file run as a script, as tests/test_torch_distributed.py runs
    its workers) take disjoint ids whose union is one process's batch
    of twice the size, scene by scene.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gta_tpu_torch.config import DataConfig, load_config
from gta_tpu_torch.data import device_synth as ds
from gta_tpu_torch.data.device_synth import DeviceSynthetic
from gta_tpu_torch.data.synthetic import _render
from gta_tpu_torch.geometry.rays import camera_rays_from_extrinsic
from gta_tpu_torch.models.context import SceneBatch

from tests.test_torch_distributed import ROOT, WORLD, _free_port, tiny_cfg, tiny_yaml

TIMEOUT = 120  # seconds, per rank


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    base = dict(dataset="synthetic", height=24, width=32, downsample=0, num_input_views=2, num_target_views=3,
                num_points=48, return_transform=True)
    base.update(kw)
    return DataConfig(**base)


def _jax_cfg(**kw):
    from gta_tpu.config import DataConfig as JDataConfig

    return JDataConfig(**dataclasses.asdict(_cfg(**kw)))


def _fields(batch: SceneBatch):
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None}


def _cams(n=16, seed=0):
    rng = np.random.RandomState(seed)
    az, el, r = rng.uniform(0, 2 * np.pi, n), rng.uniform(0.25, 0.9, n), rng.uniform(7, 10, n)
    return np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el), r * np.sin(el)], -1).astype(np.float32)


# -- camera functions and the renderer ---------------------------------------

def test_lookat_inv_se3_and_pixel_dirs_match_jax():
    from gta_tpu.data import device_synth as jds

    cam = _cams()
    want = np.array(jds.lookat_extrinsic_jax(cam))
    got = ds.lookat_extrinsic(torch.from_numpy(cam)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ds.inv_se3(torch.from_numpy(want)).numpy(), np.asarray(jds.inv_se3(want)),
                               atol=1e-6, rtol=0)
    for h, w in ((24, 32), (30, 40), (1, 1)):
        np.testing.assert_allclose(ds.pixel_dirs(h, w), np.asarray(jds._pixel_dirs(h, w)), atol=1e-6, rtol=0)


def _spheres(k, seed):
    rng = np.random.RandomState(seed)
    centers = np.stack([rng.uniform(-3, 3, k), rng.uniform(-3, 3, k), rng.uniform(0.3, 1.8, k)], -1)
    return (centers.astype(np.float32), rng.uniform(0.4, 1.1, k).astype(np.float32),
            rng.uniform(0.1, 1.0, (k, 3)).astype(np.float32))


def _pad(spheres, k=ds.MAX_SPHERES):
    """Radius-0 padding up to k spheres, as the generator masks absent ones."""
    c, r, col = spheres
    extra = k - len(r)
    return (np.concatenate([c, np.zeros((extra, 3), np.float32)]), np.concatenate([r, np.zeros(extra, np.float32)]),
            np.concatenate([col, np.zeros((extra, 3), np.float32)]))


# 3 and 6 spheres, 3 padded to 6 with radius 0, and a view past every sphere
CASES = {"three": (3, False, False), "six": (6, False, False), "padded": (3, True, False), "miss": (3, True, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_render_spheres_matches_jax(case):
    from gta_tpu.data import device_synth as jds

    k, pad, miss = CASES[case]
    spheres = _spheres(k, seed=k)
    if pad:
        spheres = _pad(spheres)
    cams = _cams(4, seed=1)
    ext = np.asarray(jds.lookat_extrinsic_jax(cams))
    rays = np.einsum("hwc,vck->vhwk", ds.pixel_dirs(24, 32), ext[:, :3, :3]).astype(np.float32)
    if miss:  # the spheres far behind the cameras' backs
        spheres = (spheres[0] + 100.0 * cams[0] / np.linalg.norm(cams[0]), *spheres[1:])
    for v in range(len(cams)):
        want = np.asarray(jds.render_spheres(cams[v], rays[v], *spheres))
        got = ds.render_spheres(torch.from_numpy(cams[v]), torch.from_numpy(rays[v]),
                                *map(torch.from_numpy, spheres)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        if miss and v == 0:
            bg = np.clip(0.5 + 0.4 * rays[v][..., 2:3] * np.asarray([0.6, 0.7, 1.0]), 0, 1)
            np.testing.assert_allclose(got, bg, atol=1e-6)
    # every leading dim at once: the batched form the generator calls
    got = ds.render_spheres(torch.from_numpy(cams), torch.from_numpy(rays),
                            *(torch.from_numpy(x)[None] for x in spheres)).numpy()
    want = np.stack([np.asarray(jds.render_spheres(cams[v], rays[v], *spheres)) for v in range(len(cams))])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_render_spheres_matches_the_host_renderer():
    """The port's render_spheres against data/synthetic._render (numpy,
    float64) on the same spheres and rays (tests/test_device_synth.py:34)."""
    spheres = _spheres(4, seed=3)
    cam = np.array([6.0, -4.0, 5.0], np.float32)
    ext = ds.lookat_extrinsic(torch.from_numpy(cam)).numpy()
    rays = camera_rays_from_extrinsic(ext, cam, 40, 30)
    want = _render(cam, rays, spheres)
    got = ds.render_spheres(torch.from_numpy(cam), torch.from_numpy(rays), *map(torch.from_numpy, _pad(spheres)))
    assert np.max(np.abs(got.numpy() - want)) < 2e-5


# -- batches ------------------------------------------------------------------

def test_batch_layout_is_the_host_layout():
    """Every field of SyntheticScenes' collated batch, with its shape and
    dtype, in both branches."""
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate

    for kw in ({}, {"return_transform": False}):
        cfg = _cfg(**kw)
        got = _fields(DeviceSynthetic(cfg, "val", device="cpu").batch(0, 2))
        want = _fields(collate([SyntheticScenes(cfg, "val", use_native=False)[i] for i in range(2)]))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == {k: (v.shape, v.dtype) for k, v in want.items()}


def test_geometry_self_consistency():
    """ext_i = input_tf_i @ canon maps each view's world camera position
    to its own origin (tests/test_device_synth.py:78)."""
    b = DeviceSynthetic(_cfg(), "train", seed=1, device="cpu").batch(0, 3)
    tf, canon, pos = b.input_transforms.numpy(), b.transform.numpy(), b.input_camera_pos.numpy()
    for bi in range(3):
        inv_canon = np.linalg.inv(canon[bi])
        for v in range(tf.shape[1]):
            world = inv_canon @ np.append(pos[bi, v], 1.0)
            assert np.allclose((tf[bi, v] @ canon[bi] @ world)[:3], 0.0, atol=1e-4)


def test_target_pixels_are_the_full_frames_at_their_coords():
    """Transform branch: each sampled pixel equals the full-scale frame at
    its target_coord (tests/test_device_synth.py:97), and its ray the
    canonical grid's there."""
    cfg = _cfg()
    b = DeviceSynthetic(cfg, "val", seed=2, device="cpu").batch(0, 2)
    full = DeviceSynthetic(cfg, "val", seed=2, full_scale=True, device="cpu").batch(0, 2)
    H, W = cfg.height, cfg.width
    frames = full.target_pixels.numpy().reshape(2, cfg.num_target_views, H, W, 3)
    coord = b.target_coord.numpy()
    iy, ix = np.round(coord[..., 0] * H).astype(int), np.round(coord[..., 1] * W).astype(int)
    rays = b.input_rays.numpy()[:, 0]
    for bi in range(2):
        for v in range(cfg.num_target_views):
            np.testing.assert_array_equal(frames[bi, v, iy[bi, v], ix[bi, v]], b.target_pixels[bi, v].numpy())
            np.testing.assert_array_equal(rays[bi, iy[bi, v], ix[bi, v]], b.target_rays[bi, v].numpy())
    assert len({(y, x) for y, x in zip(iy[0, 0], ix[0, 0])}) == iy.shape[-1]  # without replacement


def test_non_transform_targets_are_pixels_of_the_full_frames():
    """Non-transform branch: num_points of the target views' pixels, drawn
    without replacement; each sampled (ray, position, pixel) is a row of
    the full-scale batch's flattened target views."""
    cfg = _cfg(return_transform=False)
    b = DeviceSynthetic(cfg, "val", seed=3, device="cpu").batch(0, 2)
    full = DeviceSynthetic(cfg, "val", seed=3, full_scale=True, device="cpu").batch(0, 2)
    n = cfg.num_target_views * cfg.height * cfg.width
    assert full.target_pixels.shape == (2, n, 3) and b.target_pixels.shape == (2, cfg.num_points, 3)
    for bi in range(2):
        rows = np.concatenate([full.target_rays[bi], full.target_camera_pos[bi], full.target_pixels[bi]], -1)
        got = np.concatenate([b.target_rays[bi], b.target_camera_pos[bi], b.target_pixels[bi]], -1)
        index = {r.tobytes(): i for i, r in enumerate(rows)}
        picked = [index[r.tobytes()] for r in got]
        assert len(set(picked)) == cfg.num_points


def test_val_ids_are_disjoint_from_train_ids():
    train = DeviceSynthetic(_cfg(), "train", device="cpu")
    val, test = (DeviceSynthetic(_cfg(), mode, device="cpu") for mode in ("val", "test"))
    bt, bv, bs = train.batch(0, 4), val.batch(0, 4), test.batch(0, 4)
    ids = [set(b.sceneid.tolist()) for b in (bt, bv, bs)]
    assert not ids[0] & ids[1] and not ids[0] & ids[2] and not ids[1] & ids[2]
    assert not torch.allclose(bt.input_images, bv.input_images)
    # val ids cycle a fixed range above their base
    assert torch.equal(val.ids(ds.EVAL_CYCLE // 4, 4), val.ids(0, 4))
    assert train.ids(ds.EVAL_CYCLE // 4, 4)[0] == ds.EVAL_CYCLE


def test_flagship_train_step_on_a_device_batch():
    """One train step of the flagship at a tiny width on a device batch
    (tests/test_device_synth.py:127)."""
    from gta_tpu_torch.train.trainer import Trainer

    cfg = tiny_cfg()
    batch = DeviceSynthetic(cfg.data, "train", seed=0, device="cpu").batch(0, 2)
    metrics = Trainer(cfg, device="cpu").train_step(batch)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


@pytest.mark.parametrize("kw", [{}, {"return_transform": False}, {"overlap": True}, {"reconstruction": True, "num_target_views": 2},
                                {"avoid_zerocamorg": True, "canonical_view": False}],
                         ids=["transform", "non_transform", "overlap", "reconstruction", "world_frame"])
def test_a_scene_depends_only_on_seed_mode_and_id(kw):
    """batch(0, 8) is batch(0, 4, 0, 2) followed by batch(0, 4, 1, 2), bit
    for bit; a repeated call gives the same bits; step 1 differs."""
    gen = DeviceSynthetic(_cfg(**kw), "train", seed=5, device="cpu")
    whole, again = _fields(gen.batch(0, 8)), _fields(gen.batch(0, 8))
    halves = [_fields(gen.batch(0, 4, r, 2)) for r in range(2)]
    for k, v in whole.items():
        assert torch.equal(v, torch.cat([halves[0][k], halves[1][k]])), k
        assert torch.equal(v, again[k]), k
    nxt = _fields(gen.batch(1, 8))
    assert not torch.equal(nxt["input_images"], whole["input_images"])
    assert set(nxt["sceneid"].tolist()) == set(range(8, 16))
    # and not on the batch size or the order of the ids
    ids = gen.ids(0, 8).flip(0)[2:5]
    for k, v in _fields(gen.scenes(ids)).items():
        assert torch.equal(v, whole[k][[5, 4, 3]]), k


def test_another_seed_gives_other_scenes():
    a = DeviceSynthetic(_cfg(), "train", seed=0, device="cpu").scenes(torch.arange(4))
    b = DeviceSynthetic(_cfg(), "train", seed=1, device="cpu").scenes(torch.arange(4))
    assert not torch.allclose(a.input_images, b.input_images)


def _stats(batch):
    """(background share, pixel mean, pixel std, camera distance range,
    elevation range) of a world-frame batch's input views."""
    img, rays, pos = (np.asarray(x) for x in (batch.input_images, batch.input_rays, batch.input_camera_pos))
    bg = np.clip(0.5 + 0.4 * rays[..., 2:3] * np.asarray([0.6, 0.7, 1.0]), 0, 1)
    dist = np.linalg.norm(pos, axis=-1)
    el = np.arcsin(pos[..., 2] / dist)
    return np.all(np.abs(img - bg) < 1e-6, -1).mean(), img.mean(), img.std(), dist, el


def test_draws_match_jax_statistics():
    """Over 64 scenes (world frame: canonical_view off), against JAX's
    DeviceSynthetic at the same config: background share within 0.05,
    pixel mean and std within 0.015 (seeds 0-3 spread 0.03 / 0.005 /
    0.006 in either package); camera distances in [7, 10] and elevations
    in [0.25, 0.9]; 3-6 spheres, every count drawn."""
    from gta_tpu.data.device_synth import DeviceSynthetic as JDeviceSynthetic

    kw = dict(canonical_view=False)
    gen = DeviceSynthetic(_cfg(**kw), "train", seed=0, device="cpu")
    share, mean, std, dist, el = _stats(gen.batch(0, 64))
    j_share, j_mean, j_std, j_dist, j_el = _stats(JDeviceSynthetic(_jax_cfg(**kw), "train", seed=0).batch(0, 64))
    assert abs(share - j_share) < 0.05 and abs(mean - j_mean) < 0.015 and abs(std - j_std) < 0.015
    for d, e in ((dist, el), (j_dist, j_el)):
        assert 7.0 - 1e-4 <= d.min() and d.max() <= 10.0 + 1e-4
        assert 0.25 - 1e-5 <= e.min() and e.max() <= 0.9 + 1e-5
    _, radii, _, cams = gen.draws(ds.scene_keys(gen.key, gen.ids(0, 64)))
    assert set((radii > 0).sum(1).tolist()) == {3, 4, 5, 6}
    assert torch.all(radii[radii > 0] >= 0.4) and torch.all(radii <= 1.1)
    dist = torch.linalg.vector_norm(cams, dim=-1)
    assert 7.0 - 1e-4 <= dist.min() and dist.max() <= 10.0 + 1e-4


def test_generator_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceSynthetic(_cfg())


# -- the train CLI -------------------------------------------------------------

def _record_batches(monkeypatch):
    """Every DeviceSynthetic.batch call as (mode, step, scene ids)."""
    calls = []
    real = DeviceSynthetic.batch

    def batch(self, step, batch_size, shard_index=0, shard_count=1):
        out = real(self, step, batch_size, shard_index, shard_count)
        calls.append((self.mode, step, out.sceneid.tolist()))
        return out

    monkeypatch.setattr(DeviceSynthetic, "batch", batch)
    return calls


def _train_lines(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return {d["it"]: d["loss"] for d in map(json.loads, f) if d["kind"] == "train"}


def test_cli_device_data_trains_and_resumes_like_an_unbroken_run(tmp_path, monkeypatch, capsys):
    """--synthetic --device-data: 2 steps, then resumed for a third; the
    third step's scene ids and loss equal an unbroken 3-step run's, and
    step it trains on the generator's batch it."""
    from gta_tpu_torch.train import __main__ as t_train

    cfg = tiny_yaml(tmp_path, checkpoint_every=0, backup_every=0, validate_every=0)
    calls = _record_batches(monkeypatch)

    def run(out, exit_after, *extra):
        calls.clear()
        t_train.main([cfg, "--synthetic", "--device-data", "--device", "cpu", "--outdir", str(out), "--max-eval",
                      "4", "--exit-after", str(exit_after), *extra])
        return [c for c in calls if c[0] == "train"]

    whole = run(tmp_path / "whole", 2)
    assert [c[1] for c in whole] == [0, 1, 2] and whole[2][2] == [4, 5]
    first = run(tmp_path / "broken", 1, "--evalnow", "--visnow")
    # the 4 val batches of 1 (--max-eval 4, batch 2 // 8 -> 1), then step 0's batch, the vis batch, step 1's
    assert [c[0] for c in calls] == ["val"] * 4 + ["train", "val", "train"]
    out = capsys.readouterr().out
    assert "Loading training set (synthetic, on-device generation)..." in out and "Evaluated 4 unique scenes." in out
    assert os.path.exists(tmp_path / "broken" / "renders-val.png")
    resumed = run(tmp_path / "broken", 2)
    assert "Resumed from checkpoint at it=2" in capsys.readouterr().out
    assert first + resumed == whole
    assert _train_lines(tmp_path / "broken")[2] == _train_lines(tmp_path / "whole")[2]


def test_cli_device_data_is_ignored_on_a_dataset(tmp_path, monkeypatch, capsys):
    """As train.py: --device-data only where the dataset is synthetic after
    the --synthetic rewrite; a config's dataset with its data path trains
    from the reader."""
    from gta_tpu_torch.data import registry
    from gta_tpu_torch.train import __main__ as t_train

    cfg = tiny_yaml(tmp_path, checkpoint_every=0, backup_every=0, validate_every=0)
    calls = _record_batches(monkeypatch)
    real = registry.get_dataset
    monkeypatch.setattr(registry, "get_dataset", lambda mode, data, **kw: real(
        mode, dataclasses.replace(data, dataset="synthetic"), **kw))
    t_train.main([cfg, str(tmp_path / "no_such_dir"), "--device-data", "--device", "cpu", "--outdir",
                  str(tmp_path / "run"), "--exit-after", "0"])
    assert calls == [] and "Loading training set (clevrtr)..." in capsys.readouterr().out


def _rank_worker(cli_dir, out_path):
    """One gloo rank: the train CLI with --device-data for 2 steps, every
    train batch it made saved."""
    from gta_tpu_torch.train import __main__ as t_train

    torch.set_num_threads(1)
    made = []
    real = DeviceSynthetic.batch

    def batch(self, step, batch_size, shard_index=0, shard_count=1):
        out = real(self, step, batch_size, shard_index, shard_count)
        if self.mode == "train":
            made.append((step, shard_index, shard_count, _fields(out)))
        return out

    DeviceSynthetic.batch = batch
    t_train.main([os.path.join(cli_dir, "config.yaml"), "--synthetic", "--device-data", "--device", "cpu",
                  "--outdir", cli_dir, "--exit-after", "1", "--max-eval", "4"])
    torch.save(made, out_path)


def test_two_gloo_ranks_take_disjoint_shards_of_one_batch(tmp_path):
    """Two ranks of the train CLI at a global batch of 4: each makes its 2
    scenes a step; their ids are disjoint and together, scene by scene and
    bit for bit, they are one process's batch of 4."""
    tiny_yaml(tmp_path, batch_size=4, checkpoint_every=0, backup_every=0, validate_every=0)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(WORLD)}
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp_path), outs[r]], cwd=ROOT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    assert "Data parallel: backend gloo, world size 2, rank 0" in logs[0]
    made = [torch.load(o, weights_only=False) for o in outs]
    data = load_config(str(tmp_path / "config.yaml")).data  # as the CLI's --synthetic rewrites it
    data = dataclasses.replace(data, dataset="synthetic", height=data.height // 2**data.downsample,
                               width=data.width // 2**data.downsample, downsample=0)
    gen = DeviceSynthetic(data, "train", device="cpu")
    for step in (0, 1):
        shards = [next(m for m in made[r] if m[0] == step) for r in range(WORLD)]
        assert [s[1:3] for s in shards] == [(0, WORLD), (1, WORLD)]
        ids = [set(s[3]["sceneid"].tolist()) for s in shards]
        assert len(ids[0]) == len(ids[1]) == 2 and not ids[0] & ids[1]
        whole = _fields(gen.batch(step, 4))
        for k, v in whole.items():
            assert torch.equal(torch.cat([shards[0][3][k], shards[1][3][k]]), v), (step, k)


if __name__ == "__main__":
    _rank_worker(sys.argv[1], sys.argv[2])
