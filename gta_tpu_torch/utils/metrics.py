"""Image quality metrics. PSNR matches reference common.py:14-15; SSIM and
LPIPS come with the evaluation slice (ROADMAP queue 1)."""

from __future__ import annotations

import math

import torch


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)
