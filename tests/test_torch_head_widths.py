"""The port's attention kernels at every head width from 32 to 128, on the
CPU, against the JAX package.

The CUDA kernels have instances at head widths 32, 64, 96 and 128; any other
multiple of 8 in [32, 128] runs in the next one up, its operands
zero-padded per head and its per-view matrices and rotor tables padded with
zeros (gta_tpu_torch/ops/_cuda.py `kernel_head_dim`, `pad_heads`;
ops/gta_fused.py `_pad_tables`). Here, at C in {32, 40, 72, 128}:
  * flash_core's plain versions (forward and backward) against the Pallas
    flash_core in interpret mode, as tests/test_torch_flash_core.py holds
    them at C = 64 (forward atol 1e-5, gradients atol 1e-4);
  * the fused GTA plain versions (values, dq, dk, dv and trans_coeff's
    gradient) against the Pallas fused kernel in interpret mode, as
    tests/test_torch_gta_fused_bwd.py holds them (values 3e-5, gradients
    atol 5e-4 / rtol 1e-4);
  * the wrappers' padding: the plain versions run at the instance's width
    on the padded operands and tables, then cut back, equal the plain
    versions at C (atol 1e-6; the padded columns are exact zeros, so only
    the summation order differs);
  * the width rule: every multiple of 8 in [32, 128] maps to the smallest
    instance at or above it, anything else raises NotImplementedError
    naming ROADMAP item 3d.
And a tiny DiT at C = 72 (hidden 144, 2 heads; f_dims triv 36 + so2 36, 9
SO(2) frequencies: DiT-XL/2's head width with the published dit_gta's
half-and-half split) in both methods against the JAX DiT on its Pallas
kernels in interpret mode, at tests/test_torch_dit.py's fp32 tolerances.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gta_tpu.ops.gta_fused as jgf
from gta_tpu.config import FDims as JFDims, GTAArgs as JGTAArgs
from gta_tpu.ops.flash_core import flash_core as j_flash_core
from gta_tpu.train.dit_trainer import DiTTrainer as JDiTTrainer, dit_config_from_dict as j_dit_config_from_dict
from gta_tpu_torch.config import FDims, GTAArgs
from gta_tpu_torch.ops import _cuda, flash_core as fc, gta_fused as tgf
from gta_tpu_torch.train.dit_trainer import DiTTrainer, dit_config_from_dict
from gta_tpu_torch.weights import params_from_jax
from tests.test_torch_dit import FWD_ATOL, GRAD_ATOL, GRAD_RTOL, _batch, _dit_numerics, _jax_loss, _port_loss, \
    _random_params
from tests.test_torch_gta_fused import _reps

B, H = 2, 2
WIDTHS = (32, 40, 72, 128)
FLASH_FWD_ATOL, FLASH_GRAD_ATOL = 1e-5, 1e-4
GTA_VALUE_ATOL, GTA_GRAD_ATOL, GTA_GRAD_RTOL = 3e-5, 5e-4, 1e-4
PAD_ATOL = 1e-6

# a GTA mix at each width: (f_dims kwargs, SO(2) frequencies)
GTA_MIXES = {
    32: (dict(se3=16, so2=16), 4),
    40: (dict(triv=8, se3=16, so2=16), 4),
    72: (dict(triv=8, se3=32, so2=32), 8),
    128: (dict(se3=64, so2=64), 16),
}


def _tokens(x):
    """[B, H, T, C] numpy -> token-major [B, T, H*C] torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], -1)))


def _heads(x):
    return x.detach().reshape(x.shape[0], x.shape[1], H, -1).transpose(1, 2).numpy()


@pytest.mark.parametrize("C", WIDTHS)
def test_flash_core_plain_matches_jax_interpret_kernel(rng, C):
    scale = C**-0.5
    q, k, v, g = (rng.randn(B, H, t, C).astype(np.float32) for t in (33, 48, 48, 33))
    j_out, vjp = jax.vjp(lambda q, k, v: j_flash_core(q, k, v, scale, True), *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))
    leaves = [_tokens(x).requires_grad_() for x in (q, k, v)]
    out = fc.flash_core(*leaves, H, scale)
    out.backward(_tokens(g))
    np.testing.assert_allclose(_heads(out), np.asarray(j_out), atol=FLASH_FWD_ATOL)
    for x, want, name in zip(leaves, j_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_heads(x.grad), np.asarray(want), atol=FLASH_GRAD_ATOL, err_msg=name)


def _gta_args(C):
    fd, so2 = GTA_MIXES[C]
    return JGTAArgs(f_dims=JFDims(**fd), so2=so2), GTAArgs(f_dims=FDims(**fd), so2=so2)


@pytest.mark.parametrize("C", WIDTHS)
def test_fused_gta_plain_matches_jax_interpret_kernel(rng, C):
    """Decoder cross-attention (3 query views of 8 rays against 2 key views
    of 8 tokens): values and the gradients of q, k, v and trans_coeff."""
    jargs, targs = _gta_args(C)
    assert targs.f_dims.total == C
    jreps, treps = _reps(rng, jargs, targs, nv=2, tpv=8, nq=3, tq_per_view=8)
    q, k, v = (rng.randn(B, H, t, C).astype(np.float32) * 0.4 for t in (24, 16, 16))
    w = rng.randn(*q.shape).astype(np.float32)
    scale, tc = C**-0.5, 0.3

    def j_loss(q, k, v, tc):
        out = jgf.fused_gta_attention_v2(q, k, v, jreps, jargs, tc, scale, interpret=True)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, (0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tc))
    leaves = [_tokens(x).requires_grad_() for x in (q, k, v)]
    ttc = torch.tensor([tc], requires_grad=True)
    out = tgf.fused_gta_attention_tokens(*leaves, H, treps, targs, ttc, scale)
    out.backward(_tokens(w))
    np.testing.assert_allclose(_heads(out), np.asarray(j_out), atol=GTA_VALUE_ATOL)
    got = [_heads(x.grad) for x in leaves] + [ttc.grad.numpy().reshape(())]
    for a, b, name in zip(got, j_grads, ("dq", "dk", "dv", "dtc")):
        np.testing.assert_allclose(a, np.asarray(b), atol=GTA_GRAD_ATOL, rtol=GTA_GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("C", WIDTHS)
def test_padding_to_the_instance_width_is_exact(rng, C):
    """What a CUDA tensor's call runs, on the CPU: the operands padded to
    the instance's width (and the GTA tables with zero blocks), the plain
    versions at that width, the results cut back to C."""
    width = _cuda.kernel_head_dim("test", C)
    pad = lambda x: _cuda.pad_heads(x, H, width)  # noqa: E731
    cut = lambda x: _cuda.unpad_heads(x, H, C)  # noqa: E731
    scale = C**-0.5
    q, k, v, g = (_tokens(rng.randn(B, H, t, C).astype(np.float32)) for t in (24, 16, 16, 24))
    if width != C:
        assert pad(q).shape == (B, 24, H * width) and (pad(q).reshape(B, 24, H, width)[..., C:] == 0).all()
    assert torch.equal(cut(pad(q)), q)

    out, lse = fc.flash_core_fwd_plain(pad(q), pad(k), pad(v), H, scale, lse=True)
    want, want_lse = fc.flash_core_fwd_plain(q, k, v, H, scale, lse=True)
    np.testing.assert_allclose(cut(out).numpy(), want.numpy(), atol=PAD_ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=PAD_ATOL)
    for a, b in zip(fc.flash_core_bwd_plain(pad(q), pad(k), pad(v), H, scale, pad(g)),
                    fc.flash_core_bwd_plain(q, k, v, H, scale, g)):
        np.testing.assert_allclose(cut(a).numpy(), b.numpy(), atol=PAD_ATOL)

    jargs, targs = _gta_args(C)
    _, treps = _reps(rng, jargs, targs, nv=2, tpv=8, nq=3, tq_per_view=8)
    t = tgf.fused_tables(treps, targs, torch.tensor([0.3]))
    tp = tgf._pad_tables(t, C, width)
    out, z = tgf.gta_fused_fwd_plain(pad(q), pad(k), pad(v), tp, H, scale, store_z=True)
    want, want_z = tgf.gta_fused_fwd_plain(q, k, v, t, H, scale, store_z=True)
    np.testing.assert_allclose(cut(out).numpy(), want.numpy(), atol=PAD_ATOL)
    np.testing.assert_allclose(cut(z).numpy(), want_z.numpy(), atol=PAD_ATOL)
    got = tgf.gta_fused_bwd_plain(pad(q), pad(k), pad(v), tp, H, scale, pad(g), z)
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got,
                          tgf.gta_fused_bwd_plain(q, k, v, t, H, scale, g, want_z)):
        a = cut(a) if name in ("dq", "dk", "dv") else a[..., :C, :C]
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PAD_ATOL, err_msg=name)


def test_width_rule():
    assert _cuda.KERNEL_HEAD_DIMS == (32, 64, 96, 128)
    for C in range(32, 129, 8):
        width = _cuda.kernel_head_dim("test", C)
        assert width in _cuda.KERNEL_HEAD_DIMS and width - 32 < C <= width
    for C in (8, 16, 24, 36, 100, 136, 256):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3d"):
            _cuda.kernel_head_dim("test", C)


def _tiny_72(method, mixed_prec=False):
    """A tiny DiT at head width 72 as a run-config dict (`flash: fused`: the
    JAX trainer's TPU routing)."""
    gta = {"method": {"name": "gta", "args": {"f_dims": {"triv": 36, "so2": 36}, "so2": 9}}}
    return {
        "data": {"dataset": "imagenet", "path": None, "num_images": 64},
        "model": {"model_type": "dit", "args": {"dit_kwargs": {
            "input_size": 8, "patch_size": 2, "in_channels": 3, "hidden_size": 144, "depth": 2, "heads": 2,
            "num_classes": 4, "timesteps": 50, "attn_args": gta if method == "gta" else {"method": {"name": ""}},
        }}},
        "training": {"mixed_prec": mixed_prec, "flash": "fused", "batch_size": 4, "lr": 1e-3, "lr_warmup": 2},
    }


@pytest.mark.parametrize("method", ["gta", ""], ids=["gta", "base"])
def test_tiny_dit_at_head_width_72_matches_jax(method):
    b = _batch()
    jtr = JDiTTrainer(j_dit_config_from_dict(_tiny_72(method)))
    shapes = jax.eval_shape(lambda: jtr.init_state({"image": b["image"], "label": b["label"]}).params)
    params = _random_params(shapes, seed=7)
    with pytest.MonkeyPatch.context() as patch:
        _dit_numerics(patch)
        (_, (j_metrics, j_out)), j_grads = jax.jit(jax.value_and_grad(lambda p: _jax_loss(jtr, p, b), has_aux=True))(
            params)
    trainer = DiTTrainer(dit_config_from_dict(_tiny_72(method)), device="cpu")
    assert trainer.cfg.model.hidden_size // trainer.cfg.model.heads == 72
    trainer.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    loss, metrics, out = _port_loss(trainer, b)
    loss.backward()
    assert np.abs(np.asarray(j_out)).max() > 0.5
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=FWD_ATOL, rtol=0)
    for key, value in j_metrics.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), atol=1e-5, rtol=0, err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {n: p.grad for n, p in trainer.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
