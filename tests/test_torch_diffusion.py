"""The DiT family's diffusion runtime in the port (gta_tpu_torch/train/
diffusion.py) against the JAX package's (gta_tpu/train/diffusion.py), on
the CPU: the schedule tables, the forward process, the posterior and the
learned variance, the KL, the hybrid loss and its gradient, classifier-free
guidance, and the DDIM and DDPM samplers with JAX's own draws handed in.

Tolerances: the tables are built in float64 by the same numpy code and
must be equal; the elementwise fp32 formulas agree to 1e-6 (atol, values
of order 1-10); the samplers, which chain 10-50 steps of fp32 arithmetic
through a model, to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.train import diffusion as jd
from gta_tpu_torch.train import diffusion as td

ATOL = 1e-6
SAMPLER_ATOL = 1e-4
FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_acp", "sqrt_one_minus_acp", "sqrt_recip_acp",
          "sqrt_recipm1_acp", "posterior_variance", "posterior_log_variance", "posterior_mean_c0",
          "posterior_mean_ct")


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("T,b0,b1", [(1000, 1e-4, 2e-2), (50, 1e-4, 2e-2), (100, 5e-4, 1e-2)])
def test_schedule_tables_equal(T, b0, b1):
    j, t = jd.make_schedule(T, b0, b1), td.make_schedule(T, b0, b1)
    assert t.timesteps == j.timesteps == T
    for name in FIELDS:
        a, b = getattr(t, name).numpy(), getattr(j, name)
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _draw(seed, shape=(3, 4, 4, 2)):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32)


def test_forward_process_posterior_and_variance():
    T = 100
    j, t = jd.make_schedule(T), td.make_schedule(T)
    x0, noise, v = _draw(0), _draw(1), np.tanh(_draw(2))
    ts = np.array([0, 37, 99])
    jt, tt = jnp.asarray(ts), _t(ts)
    pairs = [
        (jd.q_sample(j, x0, jt, noise), td.q_sample(t, _t(x0), tt, _t(noise))),
        (jd._pred_x0_from_eps(j, x0, jt, noise), td._pred_x0_from_eps(t, _t(x0), tt, _t(noise))),
        (jd._posterior_mean(j, x0, noise, jt), td._posterior_mean(t, _t(x0), _t(noise), tt)),
        (jd._model_logvar(j, v, jt), td._model_logvar(t, _t(v), tt)),
        (jd._normal_kl(x0, v, noise, 0.5 * v), td._normal_kl(_t(x0), _t(v), _t(noise), 0.5 * _t(v))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _model_out(x_t, t, w, np_mod):
    """A fixed nonlinear 'model' [B, H, W, C] -> [B, H, W, 2C] (eps ++ v),
    the same function in either framework (`np_mod`: jnp or torch)."""
    f = t.astype(np.float32) if np_mod is jnp else t.float()
    eps = np_mod.tanh(x_t * w[0] + f[:, None, None, None] * 0.01)
    v = np_mod.tanh(x_t * w[1] - 0.2)
    return np_mod.concatenate([eps, v], -1) if np_mod is jnp else torch.cat([eps, v], -1)


@pytest.mark.parametrize("learn_sigma,vb_weight", [(True, 1.0), (True, 0.001), (False, 1.0)])
def test_training_loss_and_its_gradient(learn_sigma, vb_weight):
    """(loss, mse, vb) at given t and noise at 1e-6, and the gradient with
    respect to the model output: the VB term reaches only the variance
    channels (eps is detached in its mean), so the eps channels' gradient is
    L_simple's alone."""
    T = 50
    j, t = jd.make_schedule(T), td.make_schedule(T)
    x0, noise = _draw(3), _draw(4)
    ts = np.array([0, 1, 49])
    out = np.concatenate([_draw(5), np.tanh(_draw(6))], -1) if learn_sigma else _draw(5)

    def j_loss(o):
        return jd.training_loss(j, lambda xt, tt: o, jnp.asarray(x0), jnp.asarray(ts), jnp.asarray(noise),
                                learn_sigma, vb_weight)

    (jl, jm), jg = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(out))
    o = _t(out).requires_grad_()
    tl, tm = td.training_loss(t, lambda xt, tt: o, _t(x0), _t(ts), _t(noise), learn_sigma, vb_weight)
    tl.backward()
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jg), atol=ATOL, rtol=0)
    C = x0.shape[-1]
    mse_grad = 2.0 * (out[..., :C] - noise) / noise.size
    np.testing.assert_allclose(o.grad.numpy()[..., :C], mse_grad, atol=ATOL, rtol=0)
    if learn_sigma:
        assert np.abs(o.grad.numpy()[..., C:]).max() > 0


def test_cfg_model_fn_matches_jax_and_guidance_zero_is_unconditional():
    x, tt = _draw(7, (2, 4, 4, 3)), np.array([3, 9])
    labels = np.array([2, 0])

    def model(np_mod):
        def fn(x, t, y):
            f = (y.astype(np.float32) if np_mod is jnp else y.float())[:, None, None, None]
            return np_mod.concatenate([x * (1 + f), x - f], -1) if np_mod is jnp else torch.cat([x * (1 + f), x - f], -1)
        return fn

    for g in (0.0, 1.0, 4.0):
        want = jd.cfg_model_fn(model(jnp), jnp.asarray(labels), 5, g)(jnp.asarray(x), jnp.asarray(tt))
        got = td.cfg_model_fn(model(torch), _t(labels), 5, g)(_t(x), _t(tt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        if g == 0.0:  # the eps channels are the null label's; the variance the conditional branch's
            np.testing.assert_allclose(got[..., :3].numpy(), x * 6, atol=ATOL)
            np.testing.assert_allclose(got[..., 3:].numpy(), x - labels[:, None, None, None], atol=ATOL)
    calls = {}

    def record(x, t, y):
        calls["y"] = y
        return torch.ones_like(x) * y[:, None, None, None].float()

    out = td.cfg_model_fn(record, torch.tensor([2, 3]), 7, 0.0)(torch.zeros((2, 4, 4, 3)), torch.zeros(2))
    assert torch.equal(calls["y"], torch.tensor([2, 3, 7, 7]))
    assert torch.all(out == 7.0)


def _jax_draws(key, shape, n):
    """The normal draws of JAX's samplers, in order: the initial x, then one
    per step (rng, r = split(rng))."""
    key, r0 = jax.random.split(key)
    out = [np.asarray(jax.random.normal(r0, shape, jnp.float32))]
    for _ in range(n):
        key, rn = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(rn, shape, jnp.float32)))
    return out


def _handed(draws):
    it = iter(draws)
    return lambda shape: torch.from_numpy(next(it).copy()).reshape(shape)


W = (0.7, -0.4)


@pytest.mark.parametrize("steps,eta,learn_sigma", [(10, 0.0, True), (7, 0.0, False), (10, 0.5, True)])
def test_ddim_sample_with_jax_draws(steps, eta, learn_sigma):
    T, shape = 100, (2, 4, 4, 3)
    j, t = jd.make_schedule(T), td.make_schedule(T)
    C = shape[-1]

    def jfn(x, tt):
        o = _model_out(x, tt, W, jnp)
        return o if learn_sigma else o[..., :C]

    def tfn(x, tt):
        o = _model_out(x, tt, W, torch)
        return o if learn_sigma else o[..., :C]

    key = jax.random.PRNGKey(3)
    want = jd.ddim_sample(j, jfn, shape, key, steps=steps, eta=eta, learn_sigma=learn_sigma)
    got = td.ddim_sample(t, tfn, shape, _handed(_jax_draws(key, shape, steps)), steps=steps, eta=eta,
                         learn_sigma=learn_sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLER_ATOL, rtol=0)


@pytest.mark.parametrize("learn_sigma,clip", [(True, 1.0), (False, 1.0), (True, 0.5)])
def test_ddpm_sample_with_jax_draws(learn_sigma, clip):
    T, shape = 50, (2, 4, 4, 3)
    j, t = jd.make_schedule(T), td.make_schedule(T)
    C = shape[-1]
    key = jax.random.PRNGKey(4)
    want = jd.ddpm_sample(j, lambda x, tt: _model_out(x, tt, W, jnp)[..., :2 * C if learn_sigma else C], shape, key,
                          learn_sigma=learn_sigma, clip=clip)
    got = td.ddpm_sample(t, lambda x, tt: _model_out(x, tt, W, torch)[..., :2 * C if learn_sigma else C], shape,
                         _handed(_jax_draws(key, shape, T)), learn_sigma=learn_sigma, clip=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLER_ATOL, rtol=0)


def test_generator_randn_draws_from_its_generator():
    a = td.generator_randn(torch.Generator().manual_seed(1))((2, 3))
    b = td.generator_randn(torch.Generator().manual_seed(1))((2, 3))
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_schedule_moves_to_a_device_whole():
    s = td.make_schedule(50).to("cpu")
    assert all(getattr(s, f).device.type == "cpu" for f in FIELDS)
