"""Every config under runs/ but the two DiT ones (31) in the port, on the
CPU (the port's side of tests/test_all_configs.py):

  * it builds and runs one eval_step at the shrunk width of the parity
    tests (2 heads of its head width, one block each side, small images),
    with finite PSNR; the DiT configs (ROADMAP queue 1 item 8) are the only
    ones left out;
  * its weights carry across: every parameter of the JAX model at that
    width maps by `weights.flax_path_to_torch_key` to exactly one port
    parameter of the same shape, with none left over on either side (the
    JAX shapes from `jax.eval_shape` of its init: nothing is computed).
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.models.srt import build_model as j_build_model
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.models.srt import build_model
from gta_tpu_torch.weights import _flatten, _orient, flax_path_to_torch_key
from tests.test_torch_gta_ablations import shrink

CONFIGS = sorted(p for p in glob.glob("runs/*/*/*/config.yaml") if "/DiT/" not in p)


def test_every_config_but_dit_is_covered():
    assert len(CONFIGS) == 31
    assert len(glob.glob("runs/*/*/*/config.yaml")) == 33


@pytest.mark.parametrize("path", CONFIGS, ids=[p[len("runs/"):-len("/config.yaml")] for p in CONFIGS])
def test_config_builds_and_serves(path):
    from gta_tpu_torch.train.trainer import Trainer

    cfg = shrink(load_config(path))
    trainer = Trainer(cfg, device="cpu")
    items = [SyntheticScenes(cfg.data, "val")[i] for i in range(2)]
    psnr = trainer.eval_step(collate(items))["psnr"]
    assert psnr.shape == (2,) and torch.isfinite(psnr).all()


@pytest.mark.parametrize("path", CONFIGS, ids=[p[len("runs/"):-len("/config.yaml")] for p in CONFIGS])
def test_jax_params_map_one_to_one(path):
    cfg = shrink(load_config(path))
    items = [SyntheticScenes(cfg.data, "val")[i] for i in range(2)]
    jmodel = j_build_model(shrink(j_load_config(path)).model)
    batch = jax.tree.map(jnp.asarray, j_collate(items))
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, deterministic=True), batch)["params"]
    flat = _flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    keys = [flax_path_to_torch_key(p) for p in flat]
    assert len(set(keys)) == len(keys), "two JAX parameters map to one key"
    want = {k: _orient(p, v).shape for k, (p, v) in zip(keys, flat.items())}
    got = {n: tuple(p.shape) for n, p in build_model(cfg.model).named_parameters()}
    assert sorted(got) == sorted(want)
    for name, shape in got.items():
        assert shape == want[name], name
