"""GTA's ablations in the port against the JAX package on the CPU: the t2
span (gta_t2, CLEVR-TR and msn), euclid similarity (gta_euclid and msn
gta_so3_euclid) and elementwise_mul; and the ops under them.

  * The configs, shrunk as tests/test_torch_gta_variants.py shrinks them
    (2 heads of the config's head width, one block each side, small
    images, dropout 0, fp32: msn's bf16 configs are compared at fp32) with
    the JAX weights carried over by `params_from_jax`: eval_step pixels and
    PSNR within 1e-4, one step's loss within rtol 1e-5 and its gradients
    within atol 5e-5 / rtol 1e-3, every parameter named alike.
    `check_config` is shared with the baselines' files.
  * `gta_transform_qkv` / `gta_untransform_out` on t2, euclid and per-token
    SE(3) (ray_to_se3) reps, the sliced form beside the block-diagonal one;
    `euclid_attention` and `dot_product_attention` with a learnable tau and
    a bias; the ops/gta_pallas dispatch against
    `gta_tpu.ops.gta_pallas.fused_gta_attention(..., interpret=True)` (the
    Pallas kernels in interpret mode, as tests/test_gta_pallas.py runs
    them), forward and VJP.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.config import FDims as JFDims, GTAArgs as JGTAArgs
from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.ops import attention as jatt, gta as jgta
from gta_tpu.ops.gta_pallas import fused_gta_attention as j_fused_gta_attention
from gta_tpu.ops.reps import decoder_reps as j_decoder_reps, encoder_reps as j_encoder_reps
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch.config import FDims, GTAArgs, load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.ops import attention as tatt, gta as tgta
from gta_tpu_torch.ops.gta_pallas import fused_gta_attention
from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import params_from_jax
from tests.conftest import random_se3

B, H = 2, 2


# ---------------------------------------------------------------------------
# Configs against the JAX trainer (shared with the baselines' test files)
# ---------------------------------------------------------------------------


def shrink(cfg):
    """2 heads of the config's head width, one attention block each side,
    dropout 0, fp32; CLEVR-TR-shaped data at 32x48 (48 rays), msn-shaped
    at 32x32 (40 rays)."""
    head = cfg.model.encoder.attdim // cfg.model.encoder.heads
    msn = cfg.data.num_input_views == 5
    data = dataclasses.replace(cfg.data, dataset="synthetic", height=32, width=32 if msn else 48, downsample=0,
                               num_points=40 if msn else 48)
    enc = dataclasses.replace(cfg.model.encoder, dim=64, attdim=2 * head, heads=2, num_att_blocks=1, dropout=0.0)
    dec = dataclasses.replace(cfg.model.decoder, z_dim=2 * head, heads=2, rmlp_dim=64, num_att_blocks=1,
                              dropout=0.0)
    return dataclasses.replace(cfg, data=data, model=dataclasses.replace(cfg.model, encoder=enc, decoder=dec),
                               training=dataclasses.replace(cfg.training, mixed_prec=False))


def _jbatch(items):
    return jax.tree.map(jnp.asarray, j_collate(items))


def check_config(path):
    """The shrunk config at `path` in the port against the JAX trainer on the
    same weights and items; returns the port's Trainer."""
    cfg = shrink(load_config(path))
    ds = SyntheticScenes(cfg.data, "train")
    jtr = JTrainer(shrink(j_load_config(path)))
    params = jtr.init_state(_jbatch([ds[0], ds[1]]), seed=0).params
    ttr = Trainer(cfg, device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))

    items = [SyntheticScenes(cfg.data, "val")[i] for i in (2, 3)]
    want_px, _ = jtr.model.apply(params, _jbatch(items), deterministic=True)
    with torch.no_grad():
        got_px, _ = ttr.model(collate(items))
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=1e-4)
    np.testing.assert_allclose(ttr.eval_step(collate(items))["psnr"].numpy(),
                               np.asarray(jtr.eval_step(params, _jbatch(items))["psnr"]), atol=1e-4)

    items = [ds[4], ds[5]]
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        params, _jbatch(items), jax.random.PRNGKey(0)
    )
    loss, _, _ = ttr.loss_and_grads(collate(items))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {name: p.grad for name, p in ttr.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-3, err_msg=name)
    return ttr


@pytest.mark.parametrize("path", [
    "runs/clevrtr/GTA/gta_t2/config.yaml",
    "runs/msn/GTA/gta_t2/config.yaml",
    "runs/clevrtr/GTA/gta_euclid/config.yaml",
    "runs/msn/GTA/gta_so3_euclid/config.yaml",
    "runs/clevrtr/otherPEs/elementwise_mul/config.yaml",
], ids=["clevr_gta_t2", "msn_gta_t2", "clevr_gta_euclid", "msn_gta_so3_euclid", "elementwise_mul"])
def test_gta_ablation_matches_jax(path):
    ttr = check_config(path)
    layer = ttr.model.encoder.transformer.layers[0][0].fn
    gta = layer.attn.gta
    # elementwise_mul learns its multipliers and has no trans_coeff (JAX
    # returns before making one); the others scale their se3 span by it
    assert (layer.trans_coeff is None) == gta.elementwise_mul
    assert hasattr(layer, "rep_to_vec") == gta.elementwise_mul


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _close(got, want, atol=2e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=0)


# (f_dims, GTAArgs extras): the reps the block-diagonal form cannot express
SLICED = {
    "t2": (dict(triv=2, se3=8, t2=6), {}),
    "t2_so2": (dict(se3=8, so2=8, t2=6), dict(so2=2)),
    "euclid": (dict(triv=2, se3=9, so2=8), dict(so2=2, euclid_sim=True)),
    "euclid_so3": (dict(se3=9, so3=6, so2=8), dict(so2=2, so3=1, euclid_sim=True)),
    "ray_to_se3": (dict(se3=8, so2=8), dict(so2=2, ray_to_se3=True)),
    "no_vtransform_t2": (dict(se3=8, t2=6), dict(v_transform=False)),
}


def _sliced_case(rng, name, nv=2, tpv=6, nt=3, tt=5):
    fd, extra = SLICED[name]
    jargs = JGTAArgs(f_dims=JFDims(**fd), **extra)
    targs = GTAArgs(f_dims=FDims(**fd), **extra)
    ic, tc = rng.rand(B, nv, tpv, 2).astype(np.float32), rng.rand(B, nt, tt, 2).astype(np.float32)
    itf = np.stack([random_se3(rng, nv) for _ in range(B)])
    ttf = np.stack([random_se3(rng, nt) for _ in range(B)])
    ir, tr = rng.randn(B, nv, tpv, 3).astype(np.float32), rng.randn(B, nt, tt, 3).astype(np.float32)
    jenc = j_encoder_reps(jargs, jnp.asarray(ic), jnp.asarray(itf), jnp.asarray(ir))
    tenc = encoder_reps(targs, _t(ic), _t(itf), _t(ir))
    jdec = j_decoder_reps(jargs, jnp.asarray(tc), jnp.asarray(ttf), jnp.asarray(tr), jnp.asarray(ic),
                          jnp.asarray(itf), jnp.asarray(ir), jenc)
    tdec = decoder_reps(targs, _t(tc), _t(ttf), _t(tr), _t(ic), _t(itf), _t(ir), tenc)
    C = FDims(**fd).total
    q = rng.randn(B, H, nt * tt, C).astype(np.float32)
    k, v = (rng.randn(B, H, nv * tpv, C).astype(np.float32) for _ in range(2))
    return jargs, targs, jdec, tdec, q, k, v


@pytest.mark.parametrize("name", list(SLICED))
def test_sliced_transforms_match_jax(rng, name):
    """The sliced form on reps the block-diagonal form cannot express:
    transformed q, k, v and the output's inverse transform, and their
    gradients (trans_coeff's too), against gta_tpu.ops.gta."""
    jargs, targs, jdec, tdec, q, k, v = _sliced_case(rng, name)
    assert not tgta._blockdiag_ok(tdec, targs) and not jgta._blockdiag_ok(jdec, jargs)
    out = rng.randn(*q.shape).astype(np.float32)
    g = [rng.randn(*x.shape).astype(np.float32) for x in (q, k, v, out)]

    def j_fn(q, k, v, out, tc):
        return (*jgta.gta_transform_qkv(q, k, v, jdec, jargs, tc), jgta.gta_untransform_out(out, jdec, jargs, tc))

    jvals, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in (q, k, v, out)), jnp.asarray([0.3]))
    jgrads = vjp(tuple(jnp.asarray(x) for x in g))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, out)] + [torch.tensor([0.3], requires_grad=True)]
    tvals = (*tgta.gta_transform_qkv(*leaves[:3], tdec, targs, leaves[4]),
             tgta.gta_untransform_out(leaves[3], tdec, targs, leaves[4]))
    torch.autograd.backward(tvals, [_t(x) for x in g])
    for a, b in zip(tvals, jvals):
        _close(a, b)
    for leaf, b in zip(leaves, jgrads):
        _close(leaf.grad, b, atol=1e-4)


def test_sliced_form_matches_blockdiag_where_both_apply(rng):
    """The sliced form on block-diagonal reps (se3, so2, triv) gives the
    block-diagonal form's result."""
    args = GTAArgs(f_dims=FDims(triv=4, se3=8, so2=8), so2=2)
    coord, tf = rng.rand(B, 2, 6, 2).astype(np.float32), np.stack([random_se3(rng, 2) for _ in range(B)])
    reps = encoder_reps(args, _t(coord), _t(tf))
    q, k, v = (_t(rng.randn(B, H, 12, 20)) for _ in range(3))
    tc = torch.tensor([0.4])
    for a, b in zip(tgta._transform_sliced(q, k, v, reps, args, tc), tgta.gta_transform_qkv(q, k, v, reps, args, tc)):
        _close(a, b.numpy(), atol=1e-5)
    _close(tgta._untransform_sliced(q, reps, args, tc), tgta.gta_untransform_out(q, reps, args, tc).numpy(), atol=1e-5)


def test_sliced_form_keeps_fp32_tables_under_bf16(rng):
    """bf16 q, k, v through the sliced form come out fp32 on the transformed
    spans (the tables' dtype, as jnp.einsum promotes), and the
    concatenation promotes the untouched triv span with them."""
    jargs, targs, jdec, tdec, q, k, v = _sliced_case(rng, "t2")
    qt, kt, vt = tgta.gta_transform_qkv(*(_t(x).to(torch.bfloat16) for x in (q, k, v)), tdec, targs,
                                        torch.tensor([0.3], dtype=torch.bfloat16))
    want = jgta.gta_transform_qkv(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jdec, jargs,
                                  jnp.asarray([0.3], jnp.bfloat16))
    for a, b in zip((qt, kt, vt), want):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        _close(a, b, atol=1e-6)


@pytest.mark.parametrize("tau", [1.0, 0.7])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_ops_match_jax(rng, tau, bias):
    """dot_product_attention and euclid_attention with a tau and an additive
    bias, against gta_tpu.ops.attention: outputs, attention maps and the
    VJP (tau's cotangent too)."""
    q, k, v, g = (rng.randn(B, H, t, 12).astype(np.float32) for t in (7, 9, 9, 7))
    b = rng.randn(B, 1, 7, 9).astype(np.float32) if bias else None
    for jfn, tfn in ((jatt.dot_product_attention, tatt.dot_product_attention),
                     (jatt.euclid_attention, tatt.euclid_attention)):
        def j_out(q, k, v, tau):
            return jfn(q, k, v, 0.3, tau, None if b is None else jnp.asarray(b))[0]

        jo, vjp = jax.vjp(j_out, *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray([tau]))
        jg = vjp(jnp.asarray(g))
        leaves = [_t(x).requires_grad_() for x in (q, k, v)] + [torch.tensor([tau], requires_grad=True)]
        to, tattn = tfn(*leaves[:3], 0.3, leaves[3], None if b is None else _t(b))
        to.backward(_t(g))
        _close(to, jo)
        _close(tattn, jfn(*(jnp.asarray(x) for x in (q, k, v)), 0.3, jnp.asarray([tau]),
                          None if b is None else jnp.asarray(b))[1])
        for leaf, want in zip(leaves, jg):
            _close(leaf.grad, want, atol=1e-4)


def _tokens(x):
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)


@pytest.mark.parametrize("name", ["t2", "ray_to_se3", "no_vtransform_t2", "blockdiag"])
def test_dispatch_matches_jax_interpret_kernels(rng, name):
    """ops/gta_pallas.fused_gta_attention (on the CPU: the plain versions of
    flash_core and of the fused GTA kernels) against
    gta_tpu.ops.gta_pallas.fused_gta_attention with the Pallas kernels in
    interpret mode, on reps that take the sliced transforms and flash_core
    (t2, per-token SE(3)) and on block-diagonal ones (the fused kernel):
    the output and the VJP for q, k, v and trans_coeff."""
    if name == "blockdiag":
        fd, extra = dict(se3=8, so2=8), dict(so2=2)
        jargs, targs = JGTAArgs(f_dims=JFDims(**fd), **extra), GTAArgs(f_dims=FDims(**fd), **extra)
        ic, itf = rng.rand(B, 2, 8, 2).astype(np.float32), np.stack([random_se3(rng, 2) for _ in range(B)])
        jdec = j_encoder_reps(jargs, jnp.asarray(ic), jnp.asarray(itf), None)
        tdec = encoder_reps(targs, _t(ic), _t(itf))
        q, k, v = (rng.randn(B, H, 16, 16).astype(np.float32) for _ in range(3))
    else:
        jargs, targs, jdec, tdec, q, k, v = _sliced_case(rng, name, tpv=8, tt=8)
    assert tgta._blockdiag_ok(tdec, targs) == (name == "blockdiag")
    g = rng.randn(*q.shape).astype(np.float32)
    scale = q.shape[-1] ** -0.5

    def j_fn(q, k, v, tc):
        return j_fused_gta_attention(q, k, v, jdec, jargs, tc, scale, interpret=True)

    jo, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray([0.3]))
    jg = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)] + [torch.tensor([0.3], requires_grad=True)]
    out = fused_gta_attention(*(_tokens(x) for x in leaves[:3]), H, tdec, targs, leaves[3], scale)
    out.backward(_tokens(_t(g)))
    _close(out, _tokens(torch.from_numpy(np.array(jo))).numpy())
    for leaf, want in zip(leaves, jg):
        _close(leaf.grad, want, atol=1e-4)


@pytest.mark.parametrize("name", ["t2", "no_vtransform_t2"])
def test_dispatch_keeps_the_sliced_rows_fp32_under_bf16(rng, name):
    """bf16 q, k, v on the sliced path: flash_core takes the transforms'
    fp32 rows and gives its output in fp32, as the JAX dispatch does (its
    kernel writes q.dtype, gta_tpu/ops/flash_core.py:145): the output is
    fp32 on both sides and within 1e-5 of JAX's (Pallas in interpret mode),
    and the bf16 leaves' gradients within one bf16 ulp of JAX's."""
    bf = torch.bfloat16
    jargs, targs, jdec, tdec, q, k, v = _sliced_case(rng, name, tpv=8, tt=8)
    q, k, v = (np.asarray(_t(x).to(bf).float()) for x in (q, k, v))
    g = rng.randn(*q.shape).astype(np.float32)
    scale = q.shape[-1] ** -0.5

    def j_fn(q, k, v):
        return j_fused_gta_attention(q, k, v, jdec, jargs, jnp.asarray([0.3], jnp.bfloat16), scale, interpret=True)

    jo, vjp = jax.vjp(j_fn, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    jg = vjp(jnp.asarray(g, jo.dtype))
    leaves = [_t(x).to(bf).requires_grad_() for x in (q, k, v)]
    out = fused_gta_attention(*(_tokens(x) for x in leaves), H, tdec, targs, torch.tensor([0.3], dtype=bf), scale)
    out.backward(_tokens(_t(g)))
    assert out.dtype == torch.float32 and jo.dtype == jnp.float32
    _close(out, _tokens(torch.from_numpy(np.array(jo))).numpy(), atol=1e-5)
    for leaf, want in zip(leaves, jg):
        want = np.asarray(want, np.float32)
        assert leaf.grad.dtype == bf
        _close(leaf.grad.float(), want, atol=2.0**-8 * np.abs(want).max())


def test_dispatch_refuses_the_eager_ablations(rng):
    """euclid_sim and elementwise_mul never reach the kernels: the layer runs
    them in torch eager, as JAX runs them with XLA."""
    _, targs, _, tdec, q, k, v = _sliced_case(rng, "euclid")
    with pytest.raises(ValueError, match="torch eager"):
        fused_gta_attention(*(_tokens(_t(x)) for x in (q, k, v)), H, tdec, targs, None, 0.3)
