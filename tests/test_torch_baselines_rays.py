"""The baselines that pose rays, in the port against the JAX package on the
CPU: RePAST (`repast`, `repast_cnoise0.1`, msn `repast`), GBT's Plücker
bias (`gbt`) and FTL's latent transform (`ftl_rope`), each shrunk and held
as tests/test_torch_gta_ablations.py holds its configs (eval_step pixels
within 1e-4, one step's gradients within 5e-5 / rtol 1e-3); and
`rigid_transform`, which repast's octave encodings (up to 2^9 pi) make
ill-conditioned: it sums as XLA does, so the two agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.geometry.se3 import rigid_transform as j_rigid_transform
from gta_tpu_torch.geometry.se3 import rigid_transform
from tests.conftest import random_se3
from tests.test_torch_gta_ablations import check_config


@pytest.mark.parametrize("path", [
    "runs/clevrtr/otherPEs/repast/config.yaml",
    "runs/clevrtr/otherPEs/repast_cnoise0.1/config.yaml",
    "runs/msn/otherPEs/repast/config.yaml",
], ids=["repast", "repast_cnoise0.1", "msn_repast"])
def test_repast_matches_jax(path):
    ttr = check_config(path)
    enc, dec = ttr.model.encoder, ttr.model.decoder
    # queries augmented by 180 ray channels in the encoder, not in the
    # decoder (its queries come per key view); keys by 180 on both sides
    assert enc.transformer.layers[0][0].fn.to_q.in_features == enc.cfg.attdim + 180
    assert dec.allocation_transformer.transformer.layers[0][0].fn.to_q.in_features == dec.cfg.dim
    assert dec.allocation_transformer.transformer.layers[0][0].fn.to_k.in_features == dec.cfg.z_dim + 180


def test_gbt_matches_jax():
    ttr = check_config("runs/clevrtr/otherPEs/gbt/config.yaml")
    names = dict(ttr.model.named_parameters())
    assert "encoder.lin_ray.weight" in names
    assert names["encoder.transformer.layers.0.0.fn.geo_weights"].shape == (1,)


def test_ftl_matches_jax():
    """FTL: the latent's channel 4-vectors through inv(input extrinsic) and
    each target view's extrinsic, masked by its own trans_coeff (the
    reference's top-level key); the decoder once per target view."""
    ttr = check_config("runs/clevrtr/otherPEs/ftl_rope/config.yaml")
    assert dict(ttr.model.named_parameters())["trans_coeff"].shape == (1,)


def test_rigid_transform_matches_jax_bit_for_bit(rng):
    mats = np.stack([random_se3(rng, 3) for _ in range(2)])[:, :, None]  # [2, 3, 1, 4, 4]
    pts = (8 * rng.randn(2, 3, 1, 50, 3)).astype(np.float32)
    for tc in (1.0, 0.0):
        got = rigid_transform(torch.from_numpy(mats), torch.from_numpy(pts), tc).numpy()
        want = np.asarray(j_rigid_transform(jnp.asarray(mats), jnp.asarray(pts), tc))
        assert got.tobytes() == want.tobytes()
