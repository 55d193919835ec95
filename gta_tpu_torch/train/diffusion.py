"""Gaussian diffusion runtime for the DiT family.

Port of gta_tpu/train/diffusion.py: DDPM (scaled-linear betas, epsilon
prediction) with the improved-DDPM learned variance interpolation that the
public DiT uses, as functions over precomputed fp32 schedule tables
(`Schedule`, built in float64 and rounded to fp32, as the JAX function
builds them). The samplers run a Python loop of device ops where JAX runs
`fori_loop`.

Every random draw goes through one callable `randn(shape) -> tensor`
that the sampler takes (`generator_randn`: a torch.Generator's normal
draws on its device), in JAX's order: the initial noise, then one draw per
step (also where the step adds none), so a test can hand in JAX's own
draws.

Classifier-free guidance duplicates the batch with null labels
(`cfg_model_fn`): one model call per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Randn = Callable[[Tuple[int, ...]], torch.Tensor]


def _linear_betas(timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    # the scaled-linear schedule of DDPM / DiT (improved-DDPM appendix)
    scale = 1000.0 / timesteps
    return np.linspace(scale * beta_start, scale * beta_end, timesteps, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed diffusion tables, each [T] fp32 on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_acp: torch.Tensor
    sqrt_one_minus_acp: torch.Tensor
    sqrt_recip_acp: torch.Tensor
    sqrt_recipm1_acp: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance: torch.Tensor
    posterior_mean_c0: torch.Tensor
    posterior_mean_ct: torch.Tensor

    @property
    def timesteps(self) -> int:
        return len(self.betas)

    def to(self, device) -> "Schedule":
        return Schedule(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


def make_schedule(timesteps: int = 1000, beta_start: float = 1e-4, beta_end: float = 2e-2) -> Schedule:
    """The tables of a `timesteps`-step schedule, on the CPU."""
    betas = _linear_betas(timesteps, beta_start, beta_end)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    # the t = 0 variance is zero: its log takes t = 1's, as improved-DDPM
    post_logvar = np.log(np.append(post_var[1], post_var[1:]))

    def f32(x):
        return torch.from_numpy(x.astype(np.float32))

    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_acp=f32(np.sqrt(acp)),
        sqrt_one_minus_acp=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_acp=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_acp=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(post_var),
        posterior_log_variance=f32(post_logvar),
        posterior_mean_c0=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_ct=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
    )


def _take(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Schedule entries for per-item timesteps, broadcastable to [B, H, W, C]."""
    return table[t][:, None, None, None]


def q_sample(sch: Schedule, x0, t, noise):
    """The forward process: x_t ~ q(x_t | x_0)."""
    return _take(sch.sqrt_acp, t) * x0 + _take(sch.sqrt_one_minus_acp, t) * noise


def _pred_x0_from_eps(sch: Schedule, x_t, t, eps):
    return _take(sch.sqrt_recip_acp, t) * x_t - _take(sch.sqrt_recipm1_acp, t) * eps


def _posterior_mean(sch: Schedule, x0, x_t, t):
    return _take(sch.posterior_mean_c0, t) * x0 + _take(sch.posterior_mean_ct, t) * x_t


def _model_logvar(sch: Schedule, v, t):
    """The log-variance between beta (max) and the posterior's (min), from
    the model's raw v in [-1, 1] (improved-DDPM eq. 15)."""
    min_log = _take(sch.posterior_log_variance, t)
    max_log = torch.log(_take(sch.betas, t))
    frac = (v + 1.0) / 2.0
    return frac * max_log + (1.0 - frac) * min_log


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2) + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def training_loss(
    sch: Schedule,
    model_fn: ModelFn,
    x0: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    learn_sigma: bool = True,
    vb_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The hybrid loss L_simple + vb_weight * L_vlb (improved-DDPM / DiT).

    model_fn(x_t, t) -> [B, H, W, C] eps, or [B, H, W, 2C] with learn_sigma
    (eps, then the raw variance v). The VB term trains only the variance
    channels: its mean takes eps detached, as the DiT recipe does, so
    L_simple alone drives eps. Returns (loss, {mse, vb, loss})."""
    x_t = q_sample(sch, x0, t, noise)
    out = model_fn(x_t, t).float()
    eps, v = out.chunk(2, dim=-1) if learn_sigma else (out, None)
    mse = torch.mean((eps - noise) ** 2)
    metrics = {"mse": mse}
    loss = mse
    if learn_sigma:
        model_mean = _posterior_mean(sch, _pred_x0_from_eps(sch, x_t, t, eps.detach()), x_t, t)
        kl = _normal_kl(_posterior_mean(sch, x0, x_t, t), _take(sch.posterior_log_variance, t), model_mean,
                        _model_logvar(sch, v, t))
        # nats -> bits, averaged like improved-DDPM's mean_flat / log(2)
        vb = torch.mean(kl) / math.log(2.0)
        metrics["vb"] = vb
        loss = loss + vb_weight * vb
    metrics["loss"] = loss
    return loss, metrics


def generator_randn(generator: torch.Generator) -> Randn:
    """fp32 standard normal draws from `generator`, on its device."""
    return lambda shape: torch.randn(shape, generator=generator, device=generator.device)


def ddpm_sample(
    sch: Schedule,
    model_fn: ModelFn,
    shape: Tuple[int, ...],
    randn: Randn,
    learn_sigma: bool = True,
    clip: Optional[float] = 1.0,
) -> torch.Tensor:
    """Ancestral DDPM sampling over all T steps."""
    x = randn(shape)
    for i in range(sch.timesteps):
        t_scalar = sch.timesteps - 1 - i
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=x.device)
        out = model_fn(x, t).float()
        if learn_sigma:
            eps, v = out.chunk(2, dim=-1)
            logvar = _model_logvar(sch, v, t)
        else:
            eps, logvar = out, _take(sch.posterior_log_variance, t)
        x0_hat = _pred_x0_from_eps(sch, x, t, eps)
        if clip is not None:
            x0_hat = x0_hat.clamp(-clip, clip)
        mean = _posterior_mean(sch, x0_hat, x, t)
        noise = randn(shape)
        x = mean + float(t_scalar > 0) * torch.exp(0.5 * logvar) * noise
    return x


def ddim_sample(
    sch: Schedule,
    model_fn: ModelFn,
    shape: Tuple[int, ...],
    randn: Randn,
    steps: int = 50,
    eta: float = 0.0,
    learn_sigma: bool = True,
    clip: Optional[float] = 1.0,
) -> torch.Tensor:
    """DDIM sampling on an evenly strided sub-schedule of `steps` steps."""
    T = sch.timesteps
    ts = np.linspace(0, T - 1, steps, dtype=np.int64)[::-1].copy()
    ts_prev = np.append(ts[1:], -1)
    acp = sch.alphas_cumprod.cpu().numpy()
    x = randn(shape)
    a_t = torch.tensor(acp[ts], dtype=torch.float32, device=x.device)
    a_prev = torch.tensor(np.where(ts_prev >= 0, acp[np.maximum(ts_prev, 0)], 1.0), dtype=torch.float32,
                          device=x.device)
    for i in range(steps):
        t = torch.full((shape[0],), int(ts[i]), dtype=torch.long, device=x.device)
        out = model_fn(x, t).float()
        eps = out.chunk(2, dim=-1)[0] if learn_sigma else out
        at, ap = a_t[i], a_prev[i]
        x0_hat = (x - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        if clip is not None:
            x0_hat = x0_hat.clamp(-clip, clip)
        sigma = eta * torch.sqrt((1.0 - ap) / (1.0 - at)) * torch.sqrt(1.0 - at / ap)
        dir_xt = torch.sqrt(torch.clamp(1.0 - ap - sigma**2, min=0.0)) * eps
        noise = randn(shape)
        x = torch.sqrt(ap) * x0_hat + dir_xt + sigma * noise
    return x


def cfg_model_fn(
    model_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    null_label: int,
    guidance: float,
) -> ModelFn:
    """Classifier-free guidance, one batched call per step.

    model_fn(x, t, y) -> prediction. Returns fn(x, t) giving
    eps = eps_null + guidance * (eps_cond - eps_null) on the eps channels
    (the variance channels come from the conditional branch)."""

    def fn(x, t):
        y2 = torch.cat([labels, torch.full_like(labels, null_label)], 0)
        out = model_fn(torch.cat([x, x], 0), torch.cat([t, t], 0), y2)
        cond, uncond = out.chunk(2, dim=0)
        C = x.shape[-1]
        eps = uncond[..., :C] + guidance * (cond[..., :C] - uncond[..., :C])
        if out.shape[-1] == 2 * C:
            return torch.cat([eps, cond[..., C:]], -1)
        return eps

    return fn
