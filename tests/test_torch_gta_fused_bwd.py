"""Gradient parity of the port's fused GTA attention (gta_tpu_torch/ops/
gta_fused.py: GTAFusedAttention, gta_fused_bwd_plain) with the JAX package's
Pallas backward.

The same numpy inputs go through:
  * jax.grad of the JAX fused kernel in interpret mode
    (fused_gta_attention_v2(..., interpret=True): `_bwd_kernel` via its
    custom VJP), as tests/test_gta_fused.py runs it on the CPU;
  * the port's autograd Function on CPU tensors (its backward is
    gta_fused_bwd_plain, the backward kernel's plain version);
  * torch.autograd of the port's plain forward.
Gradients of q, k, v and trans_coeff within atol 5e-4 / rtol 1e-4, values
within 3e-5: the tolerances tests/test_gta_fused.py holds the Pallas kernel
to (fp32 throughout; summation orders differ).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gta_tpu.ops.gta_fused as jgf
from gta_tpu_torch.ops import gta_fused as tgf
from tests.test_torch_gta_fused import B, H, SCALE, _args, _qkv, _reps, _t

GRAD_ATOL, GRAD_RTOL, VALUE_ATOL = 5e-4, 1e-4, 3e-5

# call shape -> (encoder views, tokens per view, query views, tokens per
# query view, Tq, Tk); query views None = self-attention
SHAPES = {
    "decoder_cross": (2, 8, 3, 8, 24, 16),
    "misaligned_views": (4, 6, None, None, 24, 24),
    "subblocked_view": (2, 16, None, None, 32, 32),
}


def _tokens(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B, x.shape[2], -1)))


def _heads(x):
    return x.detach().reshape(B, x.shape[1], H, -1).transpose(1, 2).numpy()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mix", ["clevr", "triv_se3_so2", "rotors_only", "se3_only", "no_vtransform"])
def test_grads_match_jax_interpret_kernel(rng, monkeypatch, mix, shape):
    nv, tpv, nq, tq_pv, tq, tk = SHAPES[shape]
    if shape == "subblocked_view":
        # views larger than the JAX kernel's MAX_BQ split into SPLIT_BQ
        # query sub-blocks there; the port sees one 16-row view
        monkeypatch.setattr(jgf, "MAX_BQ", 8)
        monkeypatch.setattr(jgf, "SPLIT_BQ", 8)
        assert jgf._q_blocking(32, 2) == (1, 8)
    if shape == "misaligned_views":
        assert jgf._q_blocking(24, 4) == (4, 24)  # whole-tensor block, 6-row views
    jargs, targs = _args(mix)
    jreps, treps = _reps(rng, jargs, targs, nv=nv, tpv=tpv, nq=nq, tq_per_view=tq_pv)
    q, k, v = _qkv(rng, targs.f_dims.total, tq, tk)
    w = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    tc = 0.3

    def j_loss(q, k, v, tc):
        out = jgf.fused_gta_attention_v2(q, k, v, jreps, jargs, tc, SCALE, interpret=True)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, (0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tc)
    )
    want = [np.asarray(x) for x in j_grads]

    def port(forward):
        leaves = [_tokens(x).requires_grad_() for x in (q, k, v)]
        ttc = torch.tensor([tc], requires_grad=True)
        out = forward(leaves, ttc)
        out.backward(_tokens(w))
        grads = [_heads(x.grad) for x in leaves]
        grads.append(np.zeros(()) if ttc.grad is None else ttc.grad.numpy().reshape(()))
        return _heads(out), grads

    def through_function(leaves, ttc):
        fwd, bwd = tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches
        out = tgf.fused_gta_attention_tokens(*leaves, H, treps, targs, ttc, SCALE)
        assert out.grad_fn is not None and "GTAFusedAttention" in type(out.grad_fn).__name__
        assert (tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches) == (fwd, bwd)
        return out

    def through_plain_forward(leaves, ttc):
        t = tgf.fused_tables(treps, targs, ttc)
        return tgf.gta_fused_fwd_plain(*leaves, t, H, SCALE)

    bwd = tgf.gta_fused_bwd.launches
    for forward in (through_function, through_plain_forward):
        out, got = port(forward)
        np.testing.assert_allclose(out, np.asarray(j_out), atol=VALUE_ATOL)
        for a, b, name in zip(got, want, ("dq", "dk", "dv", "dtc")):
            np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=f"{forward.__name__} {name}")
    assert tgf.gta_fused_bwd.launches == bwd, "a CPU tensor must take the plain backward"


def test_plain_backward_matrix_cotangents_match_autograd(rng):
    """gta_fused_bwd_plain's per-view matrix cotangents (dmq, dmk, dmo,
    summed over heads) equal torch.autograd's through the plain forward,
    on the decoder shape with every table present."""
    _, targs = _args("clevr")
    _, treps = _reps(rng, *_args("clevr"), nv=2, tpv=8, nq=3, tq_per_view=8)
    q, k, v = (_tokens(x) for x in _qkv(rng, targs.f_dims.total, 24, 16))
    t = tgf.fused_tables(treps, targs, torch.tensor([0.3]))
    leaves = [x.requires_grad_() for x in (q, k, v, t.mq, t.mk, t.mo)]
    out, z = tgf.gta_fused_fwd_plain(q, k, v, t, H, SCALE, store_z=True)
    g = _t(rng.randn(*out.shape))
    want = torch.autograd.grad(out, leaves, g)
    got = tgf.gta_fused_bwd_plain(q, k, v, t, H, SCALE, g, z.detach())
    for a, b, name in zip(got, want, ("dq", "dk", "dv", "dmq", "dmk", "dmo")):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-5, err_msg=name)
