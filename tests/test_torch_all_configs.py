"""Every config under runs/ (33) and experiments/ (7) in the port, on the
CPU (the port's side of tests/test_all_configs.py):

  * the 31 NVS configs build and run one eval_step at the shrunk width of
    the parity tests (2 heads of its head width, one block each side,
    small images), with finite PSNR; the two DiT configs build at a test
    width (2 heads of their head width 64, one block, 8x8 images, batch 2;
    bf16 as published) and take one train_step and a 2-step CFG + DDIM
    sample of labels 0 and num_classes - 1, with finite values;
  * its weights carry across: every parameter of the JAX model at that
    width maps by `weights.flax_path_to_torch_key` to exactly one port
    parameter of the same shape, with none left over on either side (the
    JAX shapes from `jax.eval_shape` of its init: nothing is computed).
"""

import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.models.dit import build_dit as j_build_dit
from gta_tpu.models.srt import build_model as j_build_model
from gta_tpu.train.dit_trainer import load_dit_config as j_load_dit_config
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.images import SyntheticImages, collate_images
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.models.dit import build_dit
from gta_tpu_torch.models.srt import build_model
from gta_tpu_torch.train.dit_trainer import load_dit_config
from gta_tpu_torch.weights import _flatten, _orient, flax_path_to_torch_key
from tests.test_torch_gta_ablations import shrink

ALL = sorted(glob.glob("runs/*/*/*/config.yaml"))
CONFIGS = [p for p in ALL if "/DiT/" not in p]
DIT_CONFIGS = [p for p in ALL if "/DiT/" in p]
IDS = [p[len("runs/"):-len("/config.yaml")] for p in ALL]
# the JAX package's experiment configs: the flagship in bf16 on other
# schedules, msn_so3 on synthetic scenes, re10k gta, and two 10-class DiTs
EXPERIMENTS = sorted(glob.glob("experiments/*/config.yaml"))
EXPERIMENT_DITS = [p for p in EXPERIMENTS if "/dit_" in p]
EXPERIMENT_IDS = [p[:-len("/config.yaml")] for p in EXPERIMENTS]


def test_every_config_but_dit_is_covered():
    assert len(CONFIGS) == 31
    assert len(glob.glob("runs/*/*/*/config.yaml")) == 33


def test_every_config_is_covered():
    assert DIT_CONFIGS == ["runs/imagenet/DiT/dit_base/config.yaml", "runs/imagenet/DiT/dit_gta/config.yaml"]
    assert sorted(CONFIGS + DIT_CONFIGS) == ALL and len(ALL) == 33
    assert EXPERIMENT_IDS == ["experiments/clevrtr_decay20k", "experiments/clevrtr_decay50k",
                              "experiments/clevrtr_long150k", "experiments/dit_metric_base",
                              "experiments/dit_metric_gta", "experiments/msn_so3_40k",
                              "experiments/re10k_quality20k"]


def shrink_dit(cfg):
    """2 heads of the config's head width, one block, 8x8 images, batch 2;
    the rest (f_dims, classes, T, mixed_prec) as published."""
    m = cfg.model
    head = m.hidden_size // m.heads
    model = dataclasses.replace(m, hidden_size=2 * head, heads=2, depth=1, input_size=8)
    return dataclasses.replace(cfg, model=model, training=dataclasses.replace(cfg.training, batch_size=2))


def _shapes_map_one_to_one(flax_shapes, torch_model):
    flat = _flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), flax_shapes))
    keys = [flax_path_to_torch_key(p) for p in flat]
    assert len(set(keys)) == len(keys), "two JAX parameters map to one key"
    want = {k: _orient(p, v).shape for k, (p, v) in zip(keys, flat.items())}
    got = {n: tuple(p.shape) for n, p in torch_model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, shape in got.items():
        assert shape == want[name], name


def _dit_serves(path):
    from gta_tpu_torch.train.dit_trainer import DiTTrainer

    cfg = shrink_dit(load_dit_config(path))
    assert cfg.training.mixed_prec
    trainer = DiTTrainer(cfg, device="cpu")
    ds = SyntheticImages(8, cfg.model.num_classes, "train", 4)
    metrics = trainer.train_step(collate_images([ds[i] for i in range(2)]))
    assert all(torch.isfinite(metrics[k]) for k in ("loss", "mse", "vb", "grad_norm"))
    samples = trainer.sample(np.array([0, cfg.model.num_classes - 1]), seed=0, steps=2)
    assert samples.shape == (2, 8, 8, 3) and np.isfinite(samples).all()


@pytest.mark.parametrize("path", ALL + EXPERIMENTS, ids=IDS + EXPERIMENT_IDS)
def test_config_builds_and_serves(path):
    if path in DIT_CONFIGS + EXPERIMENT_DITS:
        return _dit_serves(path)
    from gta_tpu_torch.train.trainer import Trainer

    cfg = shrink(load_config(path))
    trainer = Trainer(cfg, device="cpu")
    items = [SyntheticScenes(cfg.data, "val")[i] for i in range(2)]
    psnr = trainer.eval_step(collate(items))["psnr"]
    assert psnr.shape == (2,) and torch.isfinite(psnr).all()


@pytest.mark.parametrize("path", ALL + EXPERIMENTS, ids=IDS + EXPERIMENT_IDS)
def test_jax_params_map_one_to_one(path):
    if path in DIT_CONFIGS + EXPERIMENT_DITS:
        cfg, jcfg = shrink_dit(load_dit_config(path)), shrink_dit(j_load_dit_config(path))
        x, t, y = jnp.zeros((2, 8, 8, 3)), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32)
        shapes = jax.eval_shape(lambda: j_build_dit(jcfg.model).init(jax.random.PRNGKey(0), x, t, y))["params"]
        return _shapes_map_one_to_one(shapes, build_dit(cfg.model))
    cfg = shrink(load_config(path))
    items = [SyntheticScenes(cfg.data, "val")[i] for i in range(2)]
    jmodel = j_build_model(shrink(j_load_config(path)).model)
    batch = jax.tree.map(jnp.asarray, j_collate(items))
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, deterministic=True), batch)["params"]
    _shapes_map_one_to_one(shapes, build_model(cfg.model))
