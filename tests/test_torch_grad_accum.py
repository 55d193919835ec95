"""Gradient accumulation in the port against the JAX package, on the CPU.

`Trainer.loss_and_grads` under training.grad_accum splits the batch into
strided microbatches (row i to microbatch i mod accum), sums their
gradients and divides by accum, as gta_tpu/train/trainer.py:131-166 does
inside its jit. The shrunk flagship of tests/test_torch_train.py, dropout
0 (the frameworks draw different dropout bits), a batch of 4 items.
The DiT ignores grad_accum in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.train.dit_trainer import DiTTrainer as JDiTTrainer, dit_config_from_dict as j_dit_config_from_dict
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.images import SyntheticImages, collate_images
from gta_tpu_torch.data.synthetic import collate
from gta_tpu_torch.train.dit_trainer import DiTTrainer, dit_config_from_dict
from gta_tpu_torch.train.trainer import Trainer, split_microbatches
from gta_tpu_torch.weights import params_from_jax
from tests.test_torch_dit import _tiny_raw
from tests.test_torch_models import FLAGSHIP
from tests.test_torch_train import _items, _pair, _train_cfg, j_params  # noqa: F401  (j_params: a fixture)

ITEMS = (0, 1, 2, 3)


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_grads_match_jax(j_params, accum):
    """loss, per-item MSE (microbatch order), every gradient and its
    global norm against JAX's scanned microbatches at the same accum."""
    jtr, state, ttr, cfg = _pair(j_params, grad_accum=accum)
    items = _items(cfg, ITEMS)
    (j_loss, j_mse), j_grads = jax.jit(jtr._grads_fn)(
        state.params, jax.tree.map(jnp.asarray, j_collate(items)), jax.random.PRNGKey(0)
    )
    loss, mse, grads = ttr.loss_and_grads(collate(items))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(mse.numpy(), np.asarray(j_mse), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {name: p.grad for name, p in ttr.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-3, err_msg=name)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(j_grads)), rtol=1e-4)


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_matches_the_full_batch_step(accum):
    """One optimizer step (lr_warmup 0: the step moves the weights) at
    accum 2 and 4 against the same trainer's unaccumulated step, at
    tests/test_grad_accum.py's tolerances."""
    cfg = _train_cfg(load_config(FLAGSHIP), lr_warmup=0)
    batch = collate(_items(cfg, ITEMS))
    full = Trainer(cfg, device="cpu")
    acc = Trainer(dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, grad_accum=accum)),
                  device="cpu")
    mf, ma = full.train_step(batch), acc.train_step(batch)
    assert ma["lr"] == mf["lr"] > 0
    np.testing.assert_allclose(ma["loss"].item(), mf["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(ma["mse"].item(), mf["mse"].item(), rtol=1e-5)
    np.testing.assert_allclose(ma["grad_norm"].item(), mf["grad_norm"].item(), rtol=1e-4)
    for (name, p), q in zip(full.model.named_parameters(), acc.model.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(), rtol=2e-4, atol=2e-6, err_msg=name)
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=2e-4, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_microbatch_rows_are_jax_strided_split(accum):
    """Every field of every microbatch (sceneid and the fields left None
    included) equals JAX's x.reshape((b // accum, accum) + ...).swapaxes(0,
    1)[i] on the same numpy batch."""
    cfg = _train_cfg(load_config(FLAGSHIP), grad_accum=accum)
    items = _items(cfg, ITEMS)
    jbatch = j_collate(items)
    split = jax.tree.map(lambda x: x.reshape((4 // accum, accum) + x.shape[1:]).swapaxes(0, 1),
                         jax.tree.map(jnp.asarray, jbatch))
    micro = split_microbatches(collate(items), accum)
    assert len(micro) == accum
    for f in dataclasses.fields(micro[0]):
        want = getattr(split, f.name)
        for i, mb in enumerate(micro):
            got = getattr(mb, f.name)
            if want is None:
                assert got is None, f.name
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]), err_msg=f"{f.name} {i}")
    assert micro[0].sceneid is not None and any(getattr(micro[0], f.name) is None for f in dataclasses.fields(micro[0]))


def test_indivisible_batch_raises_as_jax(j_params):
    jtr, state, ttr, cfg = _pair(j_params, grad_accum=2)
    items = _items(cfg, (0, 1, 2))
    msg = "batch size 3 not divisible by grad_accum=2"
    with pytest.raises(ValueError, match=msg):
        jtr._grads_fn(state.params, jax.tree.map(jnp.asarray, j_collate(items)), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=msg):
        ttr.train_step(collate(items))


def test_dit_ignores_grad_accum_as_jax():
    """training.grad_accum: 2 leaves the DiT's first step as it is with 1,
    in the port (bit for bit) and in the JAX package (plain attention:
    flash off, the XLA path on the CPU; one block, the JAX compile's
    time)."""
    ds = SyntheticImages(8, 4, "train", 16)
    batch = collate_images([ds[i] for i in range(4)])

    def raw(accum, **training):
        out = _tiny_raw("", grad_accum=accum, lr_warmup=0, **training)
        out["model"]["args"]["dit_kwargs"]["depth"] = 1
        return out

    params = {}
    for accum in (1, 2):
        trainer = DiTTrainer(dit_config_from_dict(raw(accum)), device="cpu")
        assert trainer.cfg.training.grad_accum == accum
        m = trainer.train_step(batch)
        params[accum] = ([p.detach().clone() for p in trainer.model.parameters()], m["loss"].item())
    assert params[1][1] == params[2][1]
    assert all(torch.equal(a, b) for a, b in zip(params[1][0], params[2][0]))

    jax_out, state0 = {}, None
    for accum in (1, 2):
        jtr = JDiTTrainer(j_dit_config_from_dict(raw(accum, flash="off")))
        assert jtr.cfg.training.grad_accum == accum
        state0 = state0 or jtr.init_state(batch, seed=0)
        state, m = jtr.train_step(jax.tree.map(jnp.array, state0), batch, jax.random.PRNGKey(0))
        jax_out[accum] = (jax.tree.leaves(state.params), float(m["loss"]))
    assert jax_out[1][1] == jax_out[2][1]
    assert all(np.array_equal(a, b) for a, b in zip(jax_out[1][0], jax_out[2][0]))
