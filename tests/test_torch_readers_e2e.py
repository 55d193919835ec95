"""The slice end to end on the CPU at a narrow width (2 encoder blocks and 1
decoder block, 2 heads): the CLEVR-TR flagship and re10k gta (fp32) read
from the fixtures of tests/test_torch_readers.py through the port's reader
and Loader, one eval_step and one train step against the JAX trainer on the
JAX reader's batches, with weights from `params_from_jax`, under the fp32
gates (pixels 1e-4, gradients 5e-5 / rtol 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.loader import Loader as JLoader
from gta_tpu.data.registry import get_dataset as j_get_dataset
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.loader import Loader
from gta_tpu_torch.data.registry import get_dataset
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import params_from_jax
from tests.test_torch_readers import clevr_root, jax_imageio_path, re10k_dump  # noqa: F401 (fixtures)

FLAGSHIP = "runs/clevrtr/GTA/gta/config.yaml"
RE10K_GTA = "runs/re10k/GTA/gta/config.yaml"
PX_ATOL = 1e-4  # fp32 pixels across frameworks (reduction order)
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-3  # fp32 gradients across frameworks


def _narrow(cfg, path, **data):
    """`cfg` at the tests' width (2 encoder blocks, 1 decoder block, 2 heads),
    fp32, dropout 0, reading from `path`."""
    m = cfg.model
    enc = dataclasses.replace(m.encoder, dim=64, attdim=128, heads=2, num_att_blocks=2, dropout=0.0)
    dec = dataclasses.replace(m.decoder, z_dim=128, heads=2, rmlp_dim=64, num_att_blocks=1, dropout=0.0)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, path=path, **data),
        model=dataclasses.replace(m, encoder=enc, decoder=dec),
        training=dataclasses.replace(cfg.training, mixed_prec=False),
    )


@pytest.mark.parametrize("config", [FLAGSHIP, RE10K_GTA], ids=["clevrtr_gta", "re10k_gta"])
def test_disk_batches_through_the_model_match_jax(config, clevr_root, re10k_dump, jax_imageio_path):
    """The port's reader -> Loader -> eval_step and train step against the
    JAX reader -> Loader -> the JAX trainer, same weights."""
    root, data = (clevr_root, dict(num_points=48)) if config == FLAGSHIP else \
        (re10k_dump, dict(num_points=48, height=48, width=64))  # 24x32 frames after downsample 1
    jcfg = _narrow(j_load_config(config), root, **data)
    tcfg = _narrow(load_config(config), root, **data)
    ours = Loader(get_dataset("train", tcfg.data, seed=0), 1 if config == RE10K_GTA else 2, shuffle=False)
    theirs = JLoader(j_get_dataset("train", jcfg.data, seed=0), ours.batch_size, shuffle=False, num_workers=1)
    batch, jbatch = next(iter(ours)), jax.tree.map(jnp.asarray, next(iter(theirs)))
    assert batch.input_images.shape[2:] == ((120, 160, 3) if config == FLAGSHIP else (24, 32, 3))
    for f in dataclasses.fields(batch):
        g, w = getattr(batch, f.name), getattr(jbatch, f.name)
        assert (g is None) == (w is None), f.name
        if g is not None:
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), f.name

    jtr = JTrainer(jcfg)
    state = jtr.init_state(jbatch, seed=0)
    ttr = Trainer(tcfg, device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params)))
    # JAX's eval_step and its pixels, in one compile
    want, want_px = jax.jit(lambda p, b: (jtr._eval_step_impl(p, b), jtr.model.apply(p, b, deterministic=True)[0]))(
        state.params, jbatch)
    got = ttr.eval_step(batch)
    np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(want["psnr"]), atol=PX_ATOL)
    with torch.no_grad():
        got_px, _ = ttr.model(batch)
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=PX_ATOL)

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        state.params, jbatch, jax.random.PRNGKey(0))
    loss, _, _ = ttr.loss_and_grads(batch)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want_g = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for name, p in ttr.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    m = ttr.train_step(batch)
    np.testing.assert_allclose(m["loss"].item(), float(j_loss), rtol=1e-5)
    assert ttr.step == 1
