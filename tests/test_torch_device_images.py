"""Procedural DiT images made on the device (gta_tpu_torch/data/images.
DeviceSyntheticImages) and `python -m gta_tpu_torch.train_dit
--device-data`, on the CPU, held as tests/test_dit.py:162 holds JAX's
DeviceSyntheticImages: shapes and range, repeatability, fresh ids a step,
the pixel statistics of the host dataset and of JAX's generator (within
0.05), and the spectral stripe classifier's accuracy on 120 device images
(1.0 on JAX's device images of the same ids and seeds: the port must equal
it)."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from gta_tpu_torch.data.images import DeviceSyntheticImages, SyntheticImages
from gta_tpu_torch.utils.stripe_classifier import accuracy
from tests.test_torch_dit import _tiny_raw


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(*args, **kw):
    return DeviceSyntheticImages(*args, device="cpu", **kw)


def test_shapes_range_repeatability_and_fresh_ids():
    gen = _gen(16, 10, "train", seed=0)
    b = gen.batch(0, 8)
    assert b["image"].shape == (8, 16, 16, 3) and b["image"].dtype == torch.float32
    assert b["label"].shape == (8,) and b["label"].dtype == torch.int32
    assert float(b["image"].abs().max()) <= 1.0 and 0 <= int(b["label"].min()) and int(b["label"].max()) < 10
    again = gen.batch(0, 8)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.allclose(b["image"], gen.batch(1, 8)["image"])


def test_an_image_depends_only_on_seed_mode_and_id():
    """batch(0, 8) is batch(0, 4, 0, 2) followed by batch(0, 4, 1, 2), bit
    for bit; val ids sit above train's; another seed gives other images."""
    gen = _gen(8, 10, "train", seed=3)
    whole, halves = gen.batch(0, 8), [gen.batch(0, 4, r, 2) for r in range(2)]
    for k in whole:
        assert torch.equal(whole[k], torch.cat([halves[0][k], halves[1][k]])), k
    val = _gen(8, 10, "val", seed=3)
    assert int(val.ids(0, 8).min()) >= 1 << 24 and torch.equal(val.ids(1 << 17, 8), val.ids(0, 8))
    assert not torch.allclose(whole["image"], val.batch(0, 8)["image"])
    assert not torch.allclose(whole["image"], _gen(8, 10, "train", seed=4).batch(0, 8)["image"])


def test_statistics_match_the_host_dataset_and_jax():
    """Mean and std over 64 images of 16x16 within 0.05 of SyntheticImages'
    and of JAX's DeviceSyntheticImages; every class drawn."""
    from gta_tpu.data.images import DeviceSyntheticImages as JDeviceSyntheticImages

    dev = _gen(16, 10, "train").batch(0, 64)
    img = dev["image"].numpy()
    host = np.stack([SyntheticImages(16, 10, "train")[i]["image"] for i in range(64)])
    jax_img = np.asarray(JDeviceSyntheticImages(16, 10, "train").batch(0, 64)["image"])
    for other in (host, jax_img):
        assert abs(img.mean() - other.mean()) < 0.05 and abs(img.std() - other.std()) < 0.05
    assert set(dev["label"].tolist()) == set(range(10))


@pytest.mark.parametrize("mode, seed", [("val", 0), ("train", 1)])
def test_stripe_classifier_reads_every_device_image(mode, seed):
    """utils/stripe_classifier.accuracy on 120 device images of 32x32 at 10
    classes: 1.0, JAX's accuracy on its own device images of the same ids
    and seed (measured as the port's bar)."""
    from gta_tpu.data.images import DeviceSyntheticImages as JDeviceSyntheticImages

    j = JDeviceSyntheticImages(32, 10, mode, seed=seed).batch(0, 120)
    bar = accuracy(np.asarray(j["image"]), np.asarray(j["label"]))[0]
    b = _gen(32, 10, mode, seed=seed).batch(0, 120)
    acc, per = accuracy(b["image"].numpy(), b["label"].numpy())
    assert bar == 1.0 and acc >= bar, (acc, per)


def test_dit_trainer_steps_on_a_device_batch():
    from gta_tpu_torch.train.dit_trainer import DiTTrainer, dit_config_from_dict

    cfg = dit_config_from_dict(_tiny_raw("gta"))
    trainer = DiTTrainer(cfg, device="cpu")
    batch = _gen(8, 4, "train").batch(0, 4)
    host = {k: v.numpy() for k, v in batch.items()}
    a = trainer.loss_and_grads(batch)[0]
    b = trainer.loss_and_grads(host)[0]
    assert torch.isfinite(a) and a.item() == b.item()
    assert torch.isfinite(trainer.train_step(batch)["grad_norm"])


def test_generator_needs_cuda_or_an_explicit_cpu(monkeypatch, tmp_path):
    from gta_tpu_torch import train_dit as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceSyntheticImages(8, 4)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(_tiny_raw("gta")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(path), "--device-data", "--outdir", str(tmp_path / "run"), "--exit-after", "0"])


def test_train_dit_device_data_trains_evaluates_and_resumes(tmp_path, monkeypatch, capsys):
    """train_dit --device-data on a tiny yaml: 2 steps (a sample grid, an
    eval over max-eval // (batch // 4) val batches), then resumed for a
    third; step it trains on the generator's batch it, and the resumed
    step's ids and loss are an unbroken run's."""
    from gta_tpu_torch import train_dit as cli

    calls = []
    real = DeviceSyntheticImages.batch

    def batch(self, step, batch_size, shard_index=0, shard_count=1):
        out = real(self, step, batch_size, shard_index, shard_count)
        calls.append((self.id_base, step, batch_size))
        return out

    monkeypatch.setattr(DeviceSyntheticImages, "batch", batch)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(_tiny_raw("gta", print_every=1, validate_every=2, checkpoint_every=0,
                                             backup_every=0, visualize_every=0)))

    def run(out, exit_after, *extra):
        calls.clear()
        cli.main([str(path), "--device-data", "--device", "cpu", "--outdir", str(out), "--max-eval", "4",
                  "--exit-after", str(exit_after), *extra])
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        return [c[1] for c in calls if c[0] == 0], logged

    whole, logged = run(tmp_path / "whole", 2)
    assert whole == [0, 1, 2] and [c for c in calls if c[0]] == [(1 << 24, i, 1) for i in range(4)]
    assert [(d["kind"], d["it"]) for d in logged] == [("train", 0), ("train", 1), ("eval", 2), ("train", 2)]
    first, _ = run(tmp_path / "broken", 1, "--samplenow", "--sample-steps", "2")
    out = capsys.readouterr().out
    assert "Procedural images, on-device generation." in out and "Sample grid written: samples_0.png" in out
    assert "falling back" not in out
    resumed, logged_broken = run(tmp_path / "broken", 2)
    assert "Resumed from checkpoint at it=2" in capsys.readouterr().out
    assert first + resumed == whole
    assert logged_broken[-1] == logged[-1]
