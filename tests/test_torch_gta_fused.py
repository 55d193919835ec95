"""Parity of the port's fused GTA attention forward (gta_tpu_torch/ops/
gta_fused.py) and block-diagonal oracle (ops/gta.py) with the JAX package.

The same numpy inputs go through:
  * the JAX Pallas kernel in interpret mode (fused_gta_attention_v2),
  * the JAX einsum oracle (ops/gta.gta_attention),
  * the port's plain version (what a CPU tensor runs) and its oracle.
Tolerance atol 3e-5, as tests/test_gta_fused.py holds the Pallas kernel to
the oracle: fp32 throughout, differing only in summation order.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gta_tpu.ops.gta_fused as jgf
from gta_tpu.config import FDims as JFDims, GTAArgs as JGTAArgs
from gta_tpu.ops.attention import dot_product_attention as j_dpa
from gta_tpu.ops.gta import gta_attention as j_gta_attention
from gta_tpu.ops.reps import decoder_reps as j_decoder_reps, encoder_reps as j_encoder_reps
from gta_tpu_torch.config import FDims, GTAArgs
from gta_tpu_torch.ops import gta_fused as tgf
from gta_tpu_torch.ops.attention import dot_product_attention
from gta_tpu_torch.ops.gta import gta_attention
from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps
from tests.conftest import random_se3

B, H = 2, 2
SCALE = 0.35
ATOL = 3e-5

# (f_dims kwargs, so2 freqs, v_transform)
MIXES = {
    "clevr": (dict(se3=32, so2=32), 8, True),
    "triv_se3_so2": (dict(triv=4, se3=8, so2=8), 2, True),
    "rotors_only": (dict(so2=16), 4, True),
    "se3_only": (dict(se3=16), 0, True),
    "no_vtransform": (dict(triv=4, se3=8, so2=8), 2, False),
}


def _args(name):
    fd, so2, vt = MIXES[name]
    return (
        JGTAArgs(f_dims=JFDims(**fd), so2=so2, v_transform=vt),
        GTAArgs(f_dims=FDims(**fd), so2=so2, v_transform=vt),
    )


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _reps(rng, jargs, targs, nv, tpv, nq=None, tq_per_view=None):
    """Encoder reps (or decoder reps reusing the encoder's key tables when
    nq is given) for both frameworks from the same numpy geometry."""
    coord = rng.rand(B, nv, tpv, 2).astype(np.float32)
    tf = np.stack([random_se3(rng, nv) for _ in range(B)])
    jenc = j_encoder_reps(jargs, jnp.asarray(coord), jnp.asarray(tf), None)
    tenc = encoder_reps(targs, _t(coord), _t(tf))
    if nq is None:
        return jenc, tenc
    t_coord = rng.rand(B, nq, tq_per_view, 2).astype(np.float32)
    t_tf = np.stack([random_se3(rng, nq) for _ in range(B)])
    jdec = j_decoder_reps(
        jargs, target_coord=jnp.asarray(t_coord), target_transforms=jnp.asarray(t_tf),
        input_coord=jnp.asarray(coord), input_transforms=jnp.asarray(tf), enc=jenc,
    )
    tdec = decoder_reps(
        targs, target_coord=_t(t_coord), target_transforms=_t(t_tf),
        input_coord=_t(coord), input_transforms=_t(tf), enc=tenc,
    )
    return jdec, tdec


def _qkv(rng, C, tq, tk):
    return [rng.randn(B, H, t, C).astype(np.float32) * 0.4 for t in (tq, tk, tk)]


def _fused(q, k, v, reps, args, tc):
    """The layer's token-major entry, called with [B, H, T, C] operands."""
    Bq, Hq, Tq, C = q.shape

    def tokens(x):
        return x.transpose(1, 2).reshape(Bq, x.shape[2], Hq * C)

    out = tgf.fused_gta_attention_tokens(tokens(q), tokens(k), tokens(v), Hq, reps, args, tc, SCALE)
    return out.reshape(Bq, Tq, Hq, C).transpose(1, 2)


def _check_all(jargs, targs, jreps, treps, q, k, v, tc):
    """Port plain fused forward and port oracle vs JAX interpret kernel and
    JAX oracle, all on the same inputs."""
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jtc = jnp.asarray(tc)
    j_kernel = jgf.fused_gta_attention_v2(jq, jk, jv, jreps, jargs, jtc, SCALE, interpret=True)
    j_oracle, _ = j_gta_attention(
        jq, jk, jv, functools.partial(j_dpa, scale=SCALE), jreps, jargs, jtc
    )
    tq, tk, tv = _t(q), _t(k), _t(v)
    ttc = torch.tensor([tc])
    launches = tgf.gta_fused_fwd.launches
    t_fused = _fused(tq, tk, tv, treps, targs, ttc)
    assert tgf.gta_fused_fwd.launches == launches, "a CPU tensor must take the plain version"
    t_oracle, _ = gta_attention(
        tq, tk, tv, functools.partial(dot_product_attention, scale=SCALE), treps, targs, ttc
    )
    for got in (t_fused, t_oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_kernel), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_oracle), atol=ATOL)


@pytest.mark.parametrize("name", list(MIXES))
def test_mix_matches_jax(rng, name):
    jargs, targs = _args(name)
    jreps, treps = _reps(rng, jargs, targs, nv=2, tpv=8)
    q, k, v = _qkv(rng, targs.f_dims.total, 16, 16)
    _check_all(jargs, targs, jreps, treps, q, k, v, 0.3)


def test_whole_block_misaligned_views(rng):
    """Views off the 8-row grid (CLEVR encoder: 300/view) — the JAX kernel's
    whole-tensor query block; the port's rows find their view by index."""
    jargs, targs = _args("clevr")
    jreps, treps = _reps(rng, jargs, targs, nv=4, tpv=6)
    assert jgf._q_blocking(24, 4) == (4, 24)
    q, k, v = _qkv(rng, targs.f_dims.total, 24, 24)
    _check_all(jargs, targs, jreps, treps, q, k, v, 0.3)


@pytest.mark.parametrize("name", ["clevr", "no_vtransform"])
def test_decoder_cross_attention(rng, name):
    """Tq != Tk, Nq != Nk, with the decoder reusing the encoder's key tables."""
    jargs, targs = _args(name)
    jreps, treps = _reps(rng, jargs, targs, nv=2, tpv=8, nq=3, tq_per_view=8)
    q, k, v = _qkv(rng, targs.f_dims.total, 24, 16)
    _check_all(jargs, targs, jreps, treps, q, k, v, 0.15)


def test_subblocked_large_view(rng, monkeypatch):
    """Aligned views larger than the JAX kernel's MAX_BQ split into SPLIT_BQ
    sub-blocks there; the port sees one view of 16 rows."""
    monkeypatch.setattr(jgf, "MAX_BQ", 8)
    monkeypatch.setattr(jgf, "SPLIT_BQ", 8)
    jargs, targs = _args("triv_se3_so2")
    jreps, treps = _reps(rng, jargs, targs, nv=2, tpv=16)
    assert jgf._q_blocking(32, 2) == (1, 8)
    q, k, v = _qkv(rng, targs.f_dims.total, 32, 32)
    _check_all(jargs, targs, jreps, treps, q, k, v, 0.2)


def test_uncovered_calls_raise(rng):
    """The fused kernels take no call they do not cover: euclid_sim and
    t2 reps raise, naming the dispatch that routes them
    (ops/gta_pallas.fused_gta_attention: the sliced transforms, then
    flash_core or torch eager)."""
    _, treps = _reps(rng, *_args("clevr"), nv=2, tpv=8)
    q, k, v = (_t(x) for x in _qkv(rng, 64, 16, 16))
    with pytest.raises(ValueError, match="gta_pallas"):
        _fused(q, k, v, treps, GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8, euclid_sim=True), None)
    t2_args = GTAArgs(f_dims=FDims(triv=2, se3=32, t2=30))
    t2_reps = encoder_reps(t2_args, torch.rand(B, 2, 8, 2), torch.eye(4).expand(B, 2, 4, 4))
    with pytest.raises(ValueError, match="gta_pallas"):
        _fused(q, k, v, t2_reps, t2_args, None)

