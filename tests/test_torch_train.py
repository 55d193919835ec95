"""The port's train slice against the JAX package, on the CPU.

Both trainers are built from the flagship YAML (runs/clevrtr/GTA/gta)
shrunk as tests/test_torch_models.py shrinks it (2 heads of 64 channels,
one attention block each side, 32x48 inputs, 3 target views x 16 rays),
with dropout 0: the two frameworks draw different dropout bits. The JAX
params carry over with `params_from_jax`, which maps JAX gradients (the
same tree) onto the port's parameter names too. The JAX CPU trainer runs
the XLA einsum path, so the model-level comparisons are against its
gradients; the kernel-level ones are in tests/test_torch_gta_fused_bwd.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.train.schedule import warmup_exp_decay as j_warmup_exp_decay
from gta_tpu.train.trainer import Trainer as JTrainer, TrainState
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.loader import Loader
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.train import __main__ as t_train
from gta_tpu_torch.train.checkpoint import Checkpointer
from gta_tpu_torch.train.schedule import warmup_exp_decay
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import params_from_jax
from tests.test_torch_models import FLAGSHIP, _shrink


def _train_cfg(cfg, dropout=0.0, **training):
    m = cfg.model
    model = dataclasses.replace(
        m,
        encoder=dataclasses.replace(m.encoder, dropout=dropout),
        decoder=dataclasses.replace(m.decoder, dropout=dropout),
    )
    return dataclasses.replace(
        _shrink(dataclasses.replace(cfg, model=model)),
        training=dataclasses.replace(cfg.training, **training),
    )


@pytest.fixture(scope="module")
def j_params():
    """The shrunk flagship's JAX init params (seed 0)."""
    cfg = _train_cfg(load_config(FLAGSHIP))
    jtr = JTrainer(_train_cfg(j_load_config(FLAGSHIP)))
    return jtr.init_state(jax.tree.map(jnp.asarray, j_collate(_items(cfg, (0, 1)))), seed=0).params


def _pair(params, path=FLAGSHIP, **training):
    """(JAX trainer, its fresh state, port trainer on the CPU with the same
    weights, port cfg), both from the YAML at `path` under the given
    training settings."""
    jtr = JTrainer(_train_cfg(j_load_config(path), **training))
    tcfg = _train_cfg(load_config(path), **training)
    params = jax.tree.map(jnp.array, params)  # a copy: the JAX train step donates its state
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=jtr.tx.init(params))
    ttr = Trainer(tcfg, device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jtr, state, ttr, tcfg


def _items(cfg, idx, mode="train"):
    ds = SyntheticScenes(cfg.data, mode)
    return [ds[i] for i in idx]


def _assert_params_close(ttr, jparams, atol, rtol=0.0):
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    got = dict(ttr.model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol, rtol=rtol, err_msg=name)


def test_loss_and_grads_match_jax(j_params):
    jtr, state, ttr, cfg = _pair(j_params)
    items = _items(cfg, (2, 3))
    (j_loss, j_mse), j_grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        state.params, jax.tree.map(jnp.asarray, j_collate(items)), jax.random.PRNGKey(0)
    )
    loss, mse, _ = ttr.loss_and_grads(collate(items))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(mse.numpy(), np.asarray(j_mse), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {name: p.grad for name, p in ttr.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("noadamw", [False, True])
def test_optimizer_and_schedule_match_optax(j_params, noadamw):
    """AdamW (or Adam under noadamW) under warmup_exp_decay, fed the same
    numpy gradients for 3 steps with lr_warmup=2 (step 0 has lr 0)."""
    _, state, ttr, cfg = _pair(j_params, lr=1e-3, lr_warmup=2, noadamW=noadamw)
    t = cfg.training
    sched = j_warmup_exp_decay(t.lr, t.lr_warmup, t.decay_it, t.decay_rate)
    tx = optax.adam(sched) if noadamw else optax.adamw(sched, weight_decay=t.weight_decay)
    params = state.params
    opt_state = tx.init(params)
    rng = np.random.RandomState(0)
    params_by_name = dict(ttr.model.named_parameters())
    for step in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        assert ttr.scheduler.get_last_lr()[0] == pytest.approx(float(sched(step)), rel=1e-6)
        for name, g in params_from_jax(jax.tree.map(np.asarray, grads)).items():
            params_by_name[name].grad = g
        ttr.optimizer.step()
        ttr.scheduler.step()
    _assert_params_close(ttr, params, atol=1e-6)


def test_schedule_matches_jax():
    for peak_it in (0, 2, 5000):
        ours = warmup_exp_decay(1e-4, peak_it, 1000000)
        theirs = j_warmup_exp_decay(1e-4, peak_it, 1000000)
        for it in (0, 1, 2, 3, 4999, 5000, 5001, 2000000):
            assert ours(it) == pytest.approx(float(theirs(it)), rel=1e-6)


def test_two_train_steps_match_jax(j_params):
    jtr, state, ttr, cfg = _pair(j_params, lr_warmup=2)
    rng = jax.random.PRNGKey(0)
    for step, idx in enumerate([(0, 1), (2, 3)]):
        items = _items(cfg, idx)
        state, want = jtr.train_step(state, jax.tree.map(jnp.asarray, j_collate(items)), rng)
        got = ttr.train_step(collate(items))
        for key in ("loss", "mse", "lr", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=f"step {step} {key}")
    assert ttr.step == int(state.step) == 2
    _assert_params_close(ttr, state.params, atol=1e-5)


def test_param_counts_match_jax(j_params):
    jtr, state, ttr, _ = _pair(j_params)
    assert ttr.param_counts() == jtr.param_counts(state)


def test_dropout_draws_from_the_trainer_generator_and_eval_is_deterministic():
    """Dropout masks come from the Trainer's seeded generator: two trainers
    with one seed take identical steps, and eval after training runs with
    dropout off."""
    cfg = _train_cfg(load_config(FLAGSHIP), dropout=0.5)
    batch = collate(_items(cfg, (0, 1)))
    a, b = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    torch.manual_seed(123)  # the global RNG must not matter
    la = a.train_step(batch)["loss"]
    torch.manual_seed(456)
    lb = b.train_step(batch)["loss"]
    assert la.item() == lb.item()
    assert not a.model.training
    e1, e2 = a.eval_step(batch)["mse"], a.eval_step(batch)["mse"]
    assert torch.equal(e1, e2)
    assert a.loss_and_grads(batch)[0].item() != e1.mean().item()  # training mode drops units


def test_grad_accum_raises():
    """A batch that grad_accum does not divide raises, as JAX's does."""
    cfg = _train_cfg(load_config(FLAGSHIP), grad_accum=2)
    with pytest.raises(ValueError, match="batch size 3 not divisible by grad_accum=2"):
        Trainer(cfg, device="cpu").train_step(collate(_items(cfg, (0, 1, 2))))


def test_checkpoint_round_trip_with_auto_resume_and_best(tmp_path):
    cfg = _train_cfg(load_config(FLAGSHIP), dropout=0.1, lr_warmup=1)
    batches = [collate(_items(cfg, idx)) for idx in [(0, 1), (2, 3), (4, 5)]]
    a = Trainer(cfg, device="cpu")
    a.train_step(batches[0])
    ck = Checkpointer(str(tmp_path))
    assert ck.try_restore_latest(Trainer(cfg, device="cpu")) == (False, {})
    ck.save("best", a, {"it": 0, "loss_val_best": 12.5})
    a.train_step(batches[1])
    ck.save("latest", a, {"it": 1, "epoch_it": 0})
    b = Trainer(cfg, device="cpu", seed=7)
    restored, scalars = ck.try_restore_latest(b, max_it=10)
    assert restored and scalars == {"it": 1, "epoch_it": 0} and b.step == a.step == 2
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    # optimizer moments, schedule and dropout generator carried over: the
    # next step is identical
    ma, mb = a.train_step(batches[2]), b.train_step(batches[2])
    assert ma["loss"].item() == mb["loss"].item() and ma["lr"] == mb["lr"]
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    # a stamped backup of the final step is preferred, then `best` is separate
    ck.save("step_10", a, {"it": 10})
    assert ck.try_restore_latest(Trainer(cfg, device="cpu"), max_it=10)[1] == {"it": 10}
    c = Trainer(cfg, device="cpu")
    assert ck.restore("best", c) == {"it": 0, "loss_val_best": 12.5} and c.step == 1


def test_loader_epoch_shuffle_and_drop_last():
    cfg = _train_cfg(load_config(FLAGSHIP))
    loader = Loader(SyntheticScenes(cfg.data, "train", max_len=10), 3, seed=5)
    assert len(loader) == 3
    ids = [b.sceneid.tolist() for b in loader]
    perm = np.arange(10)
    np.random.RandomState(5).shuffle(perm)
    assert ids == perm[:9].reshape(3, 3).tolist()
    loader.set_epoch(1)
    assert [b.sceneid.tolist() for b in loader] != ids


def _tiny_yaml(tmp_path, path=FLAGSHIP):
    """The YAML at `path` at the tests' width: 64x96 frames, 2 heads, one
    attention block each side, batch 2."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["data"]["num_points"] = 48
    raw["data"]["kwargs"].update(height=64, width=96)
    enc, dec = raw["model"]["args"]["encoder_kwargs"], raw["model"]["args"]["decoder_kwargs"]
    enc.update(dim=64, attdim=128, heads=2, num_att_blocks=1)
    dec.update(z_dim=128, heads=2, rmlp_dim=64, num_att_blocks=1)
    raw["training"].update(
        batch_size=2, print_every=1, checkpoint_every=2, backup_every=3, validate_every=2, lr_warmup=1
    )
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_trains_and_resumes_on_cpu(tmp_path, capsys):
    cfg = _tiny_yaml(tmp_path)
    out = str(tmp_path / "run")
    base = [cfg, "--synthetic", "--outdir", out, "--device", "cpu", "--max-eval", "2"]
    t_train.main(base + ["--exit-after", "1", "--evalnow"])
    first = capsys.readouterr().out
    assert "Number of parameters: encoder" in first and "New best model (psnr" in first
    assert "it=0, loss=" in first and "it=1, loss=" in first and "Iteration limit reached" in first
    assert "Resumed" not in first
    t_train.main(base + ["--exit-after", "3"])
    second = capsys.readouterr().out
    assert "Resumed from checkpoint at it=2" in second
    assert "it=2, loss=" in second and "Checkpoint saved." in second and "Backup checkpoint saved." in second
    for name in ("latest", "best", "step_3"):
        assert Checkpointer(out).exists(name)


def test_train_entry_points_need_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_yaml(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main([cfg, "--synthetic", "--outdir", str(tmp_path / "run"), "--exit-after", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(load_config(cfg))
