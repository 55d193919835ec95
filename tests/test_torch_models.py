"""The port's serving slice against the JAX package, end to end on the CPU.

Both models are built from the flagship YAML (runs/clevrtr/GTA/gta) shrunk
to 2 heads of 64 channels (se3:32 + so2:32), one attention block each side,
32x48 inputs and 3 target views x 16 rays. The JAX params carry over with
`params_from_jax`; eval_step pixels / PSNR and a chunked render_image must
agree to atol 1e-4 (fp32, reduction order differs across frameworks).
"""

import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import load_config as j_load_config
from gta_tpu.ops.attention import dot_product_attention as j_dpa
from gta_tpu.data.synthetic import SyntheticScenes as JSyntheticScenes, collate as j_collate
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu.utils.ref_import import flax_path_to_torch_key as j_flax_path_to_torch_key
from gta_tpu_torch import evaluate as t_evaluate
from gta_tpu_torch.config import AttnConfig, load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.models.layers import Attention, init_weights
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import flax_path_to_torch_key, params_from_jax

FLAGSHIP = "runs/clevrtr/GTA/gta/config.yaml"
ATOL = 1e-4


def _shrink(cfg):
    data = dataclasses.replace(
        cfg.data, dataset="synthetic", height=32, width=48, downsample=0, num_points=48
    )
    enc = dataclasses.replace(cfg.model.encoder, dim=64, attdim=128, heads=2, num_att_blocks=1)
    dec = dataclasses.replace(
        cfg.model.decoder, z_dim=128, heads=2, rmlp_dim=64, num_att_blocks=1
    )
    return dataclasses.replace(
        cfg, data=data, model=dataclasses.replace(cfg.model, encoder=enc, decoder=dec)
    )


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, JAX params, port trainer with the same weights, cfg)."""
    jcfg = _shrink(j_load_config(FLAGSHIP))
    tcfg = _shrink(load_config(FLAGSHIP))
    jtr = JTrainer(jcfg)
    items = [JSyntheticScenes(jcfg.data, "val", use_native=False)[i] for i in range(2)]
    state = jtr.init_state(jax.tree.map(jnp.asarray, j_collate(items)), seed=0)
    ttr = Trainer(tcfg, device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params)))
    return jtr, state.params, ttr, tcfg


def test_config_parse_matches_jax():
    """Every run config parses to the same values in both packages (the
    port keeps the fields it reads)."""
    paths = sorted(glob.glob("runs/**/config.yaml", recursive=True))
    assert paths

    def common(ours, theirs):
        if dataclasses.is_dataclass(ours):
            for f in dataclasses.fields(ours):
                common(getattr(ours, f.name), getattr(theirs, f.name))
        else:
            assert ours == theirs

    for p in paths:
        common(load_config(p), j_load_config(p))


def test_key_map_matches_reference_map(pair):
    jtr, params, ttr, _ = pair
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    for path, _ in flat:
        keys = tuple(k.key for k in path)
        assert flax_path_to_torch_key(keys) == j_flax_path_to_torch_key(keys)
    assert sorted(params_from_jax(params)) == sorted(ttr.model.state_dict())


def test_eval_step_matches_jax(pair):
    jtr, params, ttr, cfg = pair
    items = [SyntheticScenes(cfg.data, "val")[i] for i in (2, 3)]
    batch = collate(items)
    jbatch = jax.tree.map(jnp.asarray, j_collate(items))
    want = jtr.eval_step(params, jbatch)
    got = ttr.eval_step(batch)
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), atol=ATOL)
    np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(want["psnr"]), atol=ATOL)
    want_px, _ = jtr.model.apply(params, jbatch, deterministic=True)
    with torch.no_grad():
        got_px, _ = ttr.model(batch)
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=ATOL)


def test_render_image_matches_jax(pair):
    jtr, params, ttr, cfg = pair
    items = [SyntheticScenes(cfg.data, "test")[0]]
    jbatch = jax.tree.map(jnp.asarray, j_collate(items))
    tt = np.asarray(items[0]["target_transforms"][None, 1])
    want = jtr.render_image(params, jbatch, 32, 48, target_transform=tt, chunk=32)
    got = ttr.render_image(collate(items), 32, 48, target_transform=tt, chunk=32)
    assert got.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _shrink(load_config(FLAGSHIP))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_evaluate.main([FLAGSHIP, "--synthetic", "--max-scenes", "1"])
    accum = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, grad_accum=2))
    with pytest.raises(ValueError, match="not divisible by grad_accum=2"):
        Trainer(accum, device="cpu").train_step(collate([SyntheticScenes(cfg.data, "train")[0]]))


def test_plain_attention_layer_matches_jax_on_cpu_and_raises_off_cpu():
    """Method '' runs the plain version of flash attention on CPU tensors
    and the flash_core kernels on CUDA tensors; any other device raises."""
    rng = np.random.RandomState(0)
    layer = init_weights(Attention(16, heads=2, dim_head=8, attn=AttnConfig(method="")), torch.Generator().manual_seed(0))
    x = rng.randn(2, 5, 16).astype(np.float32)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    w_qkv = layer.to_qkv.weight.detach().numpy()
    q, k, v = (jnp.asarray((x @ w).reshape(2, 5, 2, 8).transpose(0, 2, 1, 3)) for w in np.split(w_qkv.T, 3, axis=1))
    o, _ = j_dpa(q, k, v, 8**-0.5)
    lin = layer.to_out[0]
    want = np.asarray(o).transpose(0, 2, 1, 3).reshape(2, 5, 16) @ lin.weight.detach().numpy().T + lin.bias.detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(NotImplementedError, match="no flash_core kernel for device meta"):
        layer.to("meta")(torch.empty(2, 5, 16, device="meta"))
