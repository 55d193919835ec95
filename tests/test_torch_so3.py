"""The port's SO(3) (Wigner-D) GTA against the JAX package, on the CPU.

  * so3 reps (encoder and decoder, with the `zeroout_so3` / `id_so3`
    ablations) and the block-diagonal tables of `_blockdiag_mat`, atol 1e-6;
  * `fused_gta_attention_tokens` at head width 96 with msn_so3's f_dims
    (se3 48, so3 24, so2 24), forward and VJP, against the JAX fused kernel
    in interpret mode (atol 3e-5 / 5e-4), and a mix with no se3 span (the
    view count then comes from the so3 tables);
  * the synthetic scenes at msn shapes (128x128, 5 input and 5 target views
    out of 10), byte-equal to the JAX package's;
  * two models end to end, with dropout 0 and JAX weights carried over by
    `params_from_jax` (no `so3_sign_map`: both packages build the same
    Wigner basis): runs/clevrtr/GTA/gta_so3 shrunk as the flagship tests
    shrink it (2 heads of 64, one block each side, 32x48 inputs), and
    runs/msn/GTA/gta_so3 at fp32 (its `mixed_prec` overridden) shrunk to
    2 heads of 96, one block each side, 5 views of 32x32. eval_step pixels
    and a chunked render_image within 1e-4, one step's gradients within
    5e-5 / rtol 1e-3, params after two steps within 1e-5;
  * the published msn_so3 config (bf16, no override) builds a bf16 Trainer
    with fp32 parameters;
  * the train and evaluate CLIs on the CLEVR-TR gta_so3 config.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gta_tpu.ops.gta_fused as jgf
from gta_tpu.config import DataConfig as JDataConfig, FDims as JFDims, GTAArgs as JGTAArgs
from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import SyntheticScenes as JSyntheticScenes, collate as j_collate
from gta_tpu.ops.gta import _blockdiag_mat as j_blockdiag_mat
from gta_tpu.ops.reps import decoder_reps as j_decoder_reps, encoder_reps as j_encoder_reps
from gta_tpu.train.trainer import Trainer as JTrainer, TrainState
from gta_tpu_torch import evaluate as t_evaluate
from gta_tpu_torch.config import DataConfig, FDims, GTAArgs, load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.ops import _cuda, gta_fused as tgf
from gta_tpu_torch.ops.gta import _blockdiag_mat
from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps
from gta_tpu_torch.train import __main__ as t_train
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.weights import params_from_jax
from tests.conftest import random_se3
from tests.test_torch_models import _shrink as _clevr_shrink
from tests.test_torch_train import _tiny_yaml

CLEVR_SO3 = "runs/clevrtr/GTA/gta_so3/config.yaml"
MSN_SO3 = "runs/msn/GTA/gta_so3/config.yaml"
B, H, SCALE = 2, 2, 0.3
REP_ATOL, VALUE_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-6, 3e-5, 5e-4, 1e-4
PX_ATOL = 1e-4

# (f_dims, so2 freqs, max so3 degree, extra GTAArgs)
MIXES = {
    "msn_so3": (dict(se3=48, so3=24, so2=24), 6, 2, {}),
    "clevr_so3": (dict(se3=32, so3=16, so2=16), 4, 2, {}),
    "so3_degree3_no_se3": (dict(triv=2, so3=30), 0, 3, {}),
    "msn_zeroout_so3": (dict(se3=48, so3=24, so2=24), 6, 2, dict(zeroout_so3=True)),
    "msn_id_so3": (dict(se3=48, so3=24, so2=24), 6, 2, dict(id_so3=True)),
}


def _args(name):
    fd, so2, so3, extra = MIXES[name]
    return (
        JGTAArgs(f_dims=JFDims(**fd), so2=so2, so3=so3, **extra),
        GTAArgs(f_dims=FDims(**fd), so2=so2, so3=so3, **extra),
    )


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _reps(rng, jargs, targs, nv, tpv, nq, tq_pv):
    """Encoder and decoder reps of both frameworks from the same geometry;
    input view 0 has the identity camera, as canonical_view makes it."""
    coord = rng.rand(B, nv, tpv, 2).astype(np.float32)
    tf = np.stack([random_se3(rng, nv) for _ in range(B)])
    tf[:, 0] = np.eye(4, dtype=np.float32)
    t_coord = rng.rand(B, nq, tq_pv, 2).astype(np.float32)
    t_tf = np.stack([random_se3(rng, nq) for _ in range(B)])
    jenc = j_encoder_reps(jargs, jnp.asarray(coord), jnp.asarray(tf), None)
    tenc = encoder_reps(targs, _t(coord), _t(tf))
    jdec = j_decoder_reps(
        jargs, target_coord=jnp.asarray(t_coord), target_transforms=jnp.asarray(t_tf),
        input_coord=jnp.asarray(coord), input_transforms=jnp.asarray(tf), enc=jenc,
    )
    tdec = decoder_reps(
        targs, target_coord=_t(t_coord), target_transforms=_t(t_tf),
        input_coord=_t(coord), input_transforms=_t(tf), enc=tenc,
    )
    return (jenc, tenc), (jdec, tdec)


@pytest.mark.parametrize("mix", list(MIXES))
def test_so3_reps_and_blocks_match_jax(rng, mix):
    jargs, targs = _args(mix)
    for side_name, (jr, tr) in zip(("encoder", "decoder"), _reps(rng, jargs, targs, 5, 4, 3, 6)):
        for attr in ("so3_q", "so3_k"):
            want, got = getattr(jr, attr), getattr(tr, attr)
            assert len(got) == len(want) == jargs.so3
            for d, (a, b) in enumerate(zip(got, want), start=1):
                assert a.shape == b.shape == (B, a.shape[1], 2 * d + 1, 2 * d + 1)
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=REP_ATOL, err_msg=f"{side_name} {attr} {d}")
        for side in ("q", "k", "out"):
            want = j_blockdiag_mat(jr, jargs, jnp.asarray(0.3), side, jnp.float32)
            got = _blockdiag_mat(tr, targs, torch.tensor([0.3]), side, torch.float32)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REP_ATOL, err_msg=f"{side_name} {side}")


def test_so3_blocks_are_detached():
    """Wigner blocks carry no gradient (reference gta.py:194-197): the
    tables' gradient reaches trans_coeff through the se3 blocks only."""
    _, targs = _args("msn_so3")
    rng = np.random.RandomState(5)
    tf = _t(np.stack([random_se3(rng, 2) for _ in range(B)])).requires_grad_()
    reps = encoder_reps(targs, _t(rng.rand(B, 2, 4, 2)), tf)
    tc = torch.tensor([0.3], requires_grad=True)
    M = _blockdiag_mat(reps, targs, tc, "k", torch.float32)
    (g_tf,) = torch.autograd.grad(M[:, :, 48:72, 48:72].sum(), tf, allow_unused=True, retain_graph=True)
    assert g_tf is None or torch.count_nonzero(g_tf) == 0
    (g_tc,) = torch.autograd.grad(M.sum(), tc)
    assert torch.isfinite(g_tc).all() and g_tc.abs().item() > 0


def _tokens(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B, x.shape[2], -1)))


def _heads(x):
    return x.detach().reshape(B, x.shape[1], H, -1).transpose(1, 2).numpy()


@pytest.mark.parametrize("mix", ["msn_so3", "so3_degree3_no_se3"])
@pytest.mark.parametrize("cross", [False, True])
def test_fused_attention_matches_jax_interpret_kernel(rng, mix, cross):
    """Forward values and the VJP of q, k, v and trans_coeff through the
    port's fused entry (CPU tensors: the kernels' plain versions) against
    the JAX Pallas kernel in interpret mode, self-attention over 5 views
    of 8 tokens or cross-attention from 3 views of 8 rays (the JAX kernel
    takes 8-row tiles)."""
    jargs, targs = _args(mix)
    enc, dec = _reps(rng, jargs, targs, 5, 8, 3, 8)
    jreps, treps = dec if cross else enc
    C = targs.f_dims.total
    tq, tk = (24, 40) if cross else (40, 40)
    q, k, v = (rng.randn(B, H, t, C).astype(np.float32) * 0.4 for t in (tq, tk, tk))
    w = rng.randn(B, H, tq, C).astype(np.float32)
    tc = 0.3

    def j_loss(q, k, v, tc):
        out = jgf.fused_gta_attention_v2(q, k, v, jreps, jargs, tc, SCALE, interpret=True)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, (0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tc)
    )
    leaves = [_tokens(x).requires_grad_() for x in (q, k, v)]
    ttc = torch.tensor([tc], requires_grad=True)
    fwd, bwd = tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches
    out = tgf.fused_gta_attention_tokens(*leaves, H, treps, targs, ttc, SCALE)
    out.backward(_tokens(w))
    assert (tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches) == (fwd, bwd), "CPU tensors take the plain versions"
    np.testing.assert_allclose(_heads(out), np.asarray(j_out), atol=VALUE_ATOL)
    got = [_heads(x.grad) for x in leaves]
    got.append(np.zeros(()) if ttc.grad is None else ttc.grad.numpy().reshape(()))
    for a, b, name in zip(got, j_grads, ("dq", "dk", "dv", "dtc")):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_plain_versions_cover_head_width_96(rng):
    """gta_fused_bwd_plain's cotangents (dmq, dmk, dmo included) equal torch
    autograd's through gta_fused_fwd_plain at C = 96, msn_so3's decoder
    cross-attention: the plain versions are width-generic."""
    _, targs = _args("msn_so3")
    _, (_, treps) = _reps(rng, *_args("msn_so3"), 5, 4, 3, 6)
    q, k, v = (_t(rng.randn(B, t, H * 96)) for t in (18, 20, 20))
    t = tgf.fused_tables(treps, targs, torch.tensor([0.3]))
    leaves = [x.requires_grad_() for x in (q, k, v, t.mq, t.mk, t.mo)]
    out, z = tgf.gta_fused_fwd_plain(q, k, v, t, H, SCALE, store_z=True)
    g = _t(rng.randn(*out.shape))
    want = torch.autograd.grad(out, leaves, g)
    got = tgf.gta_fused_bwd_plain(q, k, v, t, H, SCALE, g, z.detach())
    for a, b, name in zip(got, want, ("dq", "dk", "dv", "dmq", "dmk", "dmo")):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-5, err_msg=name)


def test_synthetic_scenes_match_jax_at_msn_shapes():
    """msn_so3's data block (128x128, 5 input and 5 target views of 10,
    2560 rays, 16x16 input tokens per view) on the synthetic scenes: the
    same arrays as the JAX package's numpy renderer."""
    cfg = load_config(MSN_SO3).data
    assert (cfg.height, cfg.width, cfg.num_input_views, cfg.num_target_views, cfg.num_views) == (128, 128, 5, 5, 10)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dataset"] = "synthetic"
    ours = SyntheticScenes(DataConfig(**kw), "train", use_native=False)
    theirs = JSyntheticScenes(JDataConfig(**kw), "train", use_native=False)
    got, want = ours[3], theirs[3]
    assert sorted(got) == sorted(want)
    assert got["input_coord"].shape == (5, 256, 2) and got["target_pixels"].shape == (5, 512, 3)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), key


# ---------------------------------------------------------------------------
# Models end to end
# ---------------------------------------------------------------------------


def _msn_shrink(cfg):
    data = dataclasses.replace(cfg.data, dataset="synthetic", height=32, width=32, downsample=0, num_points=40)
    enc = dataclasses.replace(cfg.model.encoder, dim=64, attdim=192, heads=2, num_att_blocks=1)
    dec = dataclasses.replace(cfg.model.decoder, z_dim=192, heads=2, rmlp_dim=64, num_att_blocks=1)
    return dataclasses.replace(cfg, data=data, model=dataclasses.replace(cfg.model, encoder=enc, decoder=dec))


MODELS = {"clevr_gta_so3": (CLEVR_SO3, _clevr_shrink), "msn_gta_so3": (MSN_SO3, _msn_shrink)}


def _cfg(cfg, shrink, **training):
    """Dropout 0 (the frameworks draw different bits), fp32, shrunk."""
    m = cfg.model
    model = dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, dropout=0.0), decoder=dataclasses.replace(m.decoder, dropout=0.0)
    )
    training = {"mixed_prec": False, **training}
    return dataclasses.replace(
        shrink(dataclasses.replace(cfg, model=model)), training=dataclasses.replace(cfg.training, **training)
    )


def _items(cfg, idx, mode="train"):
    ds = SyntheticScenes(cfg.data, mode)
    return [ds[i] for i in idx]


def _jbatch(items):
    return jax.tree.map(jnp.asarray, j_collate(items))


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """(name, JAX init params at seed 0) of one shrunk so3 model."""
    path, shrink = MODELS[request.param]
    cfg = _cfg(load_config(path), shrink)
    jtr = JTrainer(_cfg(j_load_config(path), shrink))
    return request.param, jtr.init_state(_jbatch(_items(cfg, (0, 1))), seed=0).params


def _pair(model, **training):
    name, params = model
    path, shrink = MODELS[name]
    jtr = JTrainer(_cfg(j_load_config(path), shrink, **training))
    tcfg = _cfg(load_config(path), shrink, **training)
    params = jax.tree.map(jnp.array, params)  # a copy: the JAX train step donates its state
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=jtr.tx.init(params))
    ttr = Trainer(tcfg, device="cpu")
    ttr.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jtr, state, ttr, tcfg


def test_model_is_the_published_config(model):
    """Only depth, width and image size are cut: f_dims, so2/so3 degrees and
    the attention flags are the YAML's."""
    name, _ = model
    _, _, ttr, cfg = _pair(model)
    full = load_config(MODELS[name][0])
    for side, ref in ((cfg.model.encoder, full.model.encoder), (cfg.model.decoder, full.model.decoder)):
        assert side.attn == ref.attn and side.attn.gta.so3 == 2 and side.attn.gta.f_dims.so3 > 0
    head = 96 if name == "msn_gta_so3" else 64
    assert cfg.model.encoder.attdim // cfg.model.encoder.heads == cfg.model.decoder.head_dim == head
    assert cfg.model.encoder.attn.gta.f_dims.total == head


def test_eval_step_and_render_match_jax(model):
    jtr, state, ttr, cfg = _pair(model)
    items = _items(cfg, (2, 3), "val")
    jbatch = _jbatch(items)
    want = jtr.eval_step(state.params, jbatch)
    got = ttr.eval_step(collate(items))
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), atol=PX_ATOL)
    np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(want["psnr"]), atol=PX_ATOL)
    want_px, _ = jtr.model.apply(state.params, jbatch, deterministic=True)
    with torch.no_grad():
        got_px, _ = ttr.model(collate(items))
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=PX_ATOL)

    item = _items(cfg, (0,), "test")
    tt = np.asarray(item[0]["target_transforms"][None, 1])
    h, w = cfg.data.height, cfg.data.width
    want = jtr.render_image(state.params, _jbatch(item), h, w, target_transform=tt, chunk=256)
    got = ttr.render_image(collate(item), h, w, target_transform=tt, chunk=256)
    assert got.shape == (1, h, w, 3)
    np.testing.assert_allclose(got, want, atol=PX_ATOL)


def test_loss_and_grads_match_jax(model):
    jtr, state, ttr, cfg = _pair(model)
    items = _items(cfg, (2, 3))
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        state.params, _jbatch(items), jax.random.PRNGKey(0)
    )
    loss, _, _ = ttr.loss_and_grads(collate(items))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {name: p.grad for name, p in ttr.model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert any(name.endswith("trans_coeff") for name in got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-3, err_msg=name)


def test_two_train_steps_match_jax(model):
    jtr, state, ttr, cfg = _pair(model, lr_warmup=2)
    rng = jax.random.PRNGKey(0)
    for step, idx in enumerate([(0, 1), (2, 3)]):
        items = _items(cfg, idx)
        state, want = jtr.train_step(state, _jbatch(items), rng)
        got = ttr.train_step(collate(items))
        for key in ("loss", "mse", "lr", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=f"step {step} {key}")
    assert ttr.step == int(state.step) == 2
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in ttr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


def test_msn_so3_published_config_builds_bf16_trainer():
    """The published msn_so3 config (mixed_prec, no override) builds a
    Trainer that computes in bf16 with fp32 parameters, at full width; an
    operand dtype no kernel instance covers still raises, naming its
    ROADMAP item, where a CUDA tensor of it would reach the kernels."""
    cfg = load_config(MSN_SO3)
    assert cfg.training.mixed_prec
    trainer = Trainer(cfg, device="cpu")
    assert trainer.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    dtypes = {m.compute_dtype for m in trainer.model.modules() if hasattr(m, "compute_dtype")}
    assert dtypes == {torch.bfloat16}
    _cuda.check_kernel_dtype("kernel", torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3e"):
        _cuda.check_kernel_dtype("kernel", torch.float16)


def test_train_cli_on_cpu(tmp_path, capsys):
    path = _tiny_yaml(tmp_path, CLEVR_SO3)
    t_train.main([path, "--synthetic", "--outdir", str(tmp_path / "run"), "--device", "cpu", "--exit-after", "1"])
    out = capsys.readouterr().out
    assert "it=0, loss=" in out and "it=1, loss=" in out and "Iteration limit reached" in out


def test_evaluate_cli_matches_jax_render_image(tmp_path):
    """`python -m gta_tpu_torch.evaluate --device cpu` on one full-scale
    scene (64x96 targets from 32x48 inputs) with the JAX weights: the mean
    PSNR over its target views equals the JAX trainer's render_image's."""
    path = _tiny_yaml(tmp_path, CLEVR_SO3)
    cfg = _cfg(load_config(CLEVR_SO3), _clevr_shrink)
    jtr = JTrainer(_cfg(j_load_config(CLEVR_SO3), _clevr_shrink))
    params = jtr.init_state(_jbatch(_items(cfg, (0, 1))), seed=0).params
    ckpt = tmp_path / "model.pt"
    torch.save(params_from_jax(jax.tree.map(np.asarray, params)), ckpt)
    got = t_evaluate.main([path, "--synthetic", "--device", "cpu", "--max-scenes", "1", "--state-dict", str(ckpt),
                            "--outdir", str(tmp_path / "eval")])
    assert got["n_scenes"] == 1 and got["device"] == "cpu"

    tcfg = load_config(path)
    test = SyntheticScenes(dataclasses.replace(tcfg.data, dataset="synthetic"), "test", full_scale=True)
    item = test[0]
    h, w = test.target_h, test.target_w
    psnrs = []
    for v in range(item["target_transforms"].shape[0]):
        pred = jtr.render_image(params, _jbatch([item]), h, w, target_transform=item["target_transforms"][None, v],
                                chunk=16384, rays=item["target_rays"][None, v], cam=item["target_camera_pos"][None, v])
        psnrs.append(-10.0 * np.log10(np.mean((pred - item["target_pixels"][v].reshape(1, h, w, 3)) ** 2)))
    np.testing.assert_allclose(got["psnr"], np.mean(psnrs), atol=PX_ATOL)
