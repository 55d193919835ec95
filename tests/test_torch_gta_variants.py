"""The four CLEVR-TR GTA ablations that differ from the flagship only in
flags the port already reads, against the JAX package on the CPU:

  * gta_novtrnsfm    v_transform false (no value or output transform)
  * gta_sharedfreqs  shared SO(2) frequencies, max_freq 0.5
  * gta_no3demb      so2 64 in both (no se3 span, no trans_coeff), decoder
                     recompute_so2
  * gta_no2demb      se3 64 (no rotors), decoder recompute_so2

Each is shrunk as the flagship tests shrink it (2 heads of 64, one block
each side, 32x48 inputs, dropout 0) with the JAX weights carried over:
eval_step pixels within 1e-4, one step's gradients within 5e-5 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.synthetic import collate
from gta_tpu_torch.weights import params_from_jax
from tests.test_torch_train import _items, _pair, _train_cfg

VARIANTS = ["gta_novtrnsfm", "gta_sharedfreqs", "gta_no3demb", "gta_no2demb"]


def _jbatch(items):
    return jax.tree.map(jnp.asarray, j_collate(items))


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_eval_step_and_grads_match_jax(variant):
    path = f"runs/clevrtr/GTA/{variant}/config.yaml"
    cfg = _train_cfg(load_config(path))
    params = JTrainer(_train_cfg(j_load_config(path))).init_state(_jbatch(_items(cfg, (0, 1))), seed=0).params
    jtr, state, ttr, cfg = _pair(params, path)
    if variant == "gta_no3demb":
        assert ttr.model.encoder.transformer.layers[0][0].fn.trans_coeff is None

    items = _items(cfg, (2, 3), "val")
    want_px, _ = jtr.model.apply(state.params, _jbatch(items), deterministic=True)
    with torch.no_grad():
        got_px, _ = ttr.model(collate(items))
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=1e-4)
    np.testing.assert_allclose(ttr.eval_step(collate(items))["psnr"].numpy(),
                               np.asarray(jtr.eval_step(state.params, _jbatch(items))["psnr"]), atol=1e-4)

    items = _items(cfg, (4, 5))
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        state.params, _jbatch(items), jax.random.PRNGKey(0)
    )
    loss, _, _ = ttr.loss_and_grads(collate(items))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {name: p.grad for name, p in ttr.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-3, err_msg=name)
