"""Image quality metrics (the JAX package's gta_tpu/utils/metrics.py).

PSNR matches reference common.py:14-15. SSIM is the Wang et al.
formulation with an 11x11 Gaussian window, as the JAX package computes it:
the window built in float64 then cast to float32, a depthwise per-channel
filter with VALID padding, k1 0.01, k2 0.03 and the mean over everything.
Metrics run in fp32 whatever the model's compute dtype, and with TF32 off
(`no_tf32`), so a metric on the card agrees with the same call on the CPU
to fp32 rounding, inside a Trainer or without one. The JAX file's `LPIPS`
wrapper around the `lpips` package is not ported; LPIPS-VGG is
`utils/lpips.py`.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mse2psnr(torch.mean((pred.float() - target.float()) ** 2))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over [B, H, W, C] images (per-channel window statistics),
    a 0-d fp32 tensor on the images' device."""
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    pred = pred.float().permute(0, 3, 1, 2)
    target = target.float().permute(0, 3, 1, 2)
    C = pred.shape[1]
    kern = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(pred.device)
    kern = kern.expand(C, 1, window_size, window_size)

    def filt(x):
        # depthwise conv: the same window per channel
        return F.conv2d(x, kern, groups=C)

    with no_tf32():
        mu_p = filt(pred)
        mu_t = filt(target)
        mu_pp = filt(pred * pred) - mu_p**2
        mu_tt = filt(target * target) - mu_t**2
        mu_pt = filt(pred * target) - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)
    den = (mu_p**2 + mu_t**2 + c1) * (mu_pp + mu_tt + c2)
    return torch.mean(num / den)
