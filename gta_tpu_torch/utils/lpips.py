"""LPIPS-VGG, the reference's third evaluation metric (the JAX package's
gta_tpu/utils/lpips_jax.py).

The reference scores LPIPS with the `lpips` package (evaluate.py:28-48,
87-88): inputs scaled to [-1, 1], the package's shift and scale, VGG16
features at relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, each
normalised to unit length over its channels, squared differences weighted
by learned 1x1 "lin" weights, averaged over space and summed over stages.
This module computes what the JAX file computes, in NCHW: the eps sits
inside the square root of the unit normalisation, as there (the `lpips`
package adds it outside), and the 2x2 max-pool comes before the convs that
`POOL_BEFORE` marks.

Pretrained weights are not in the repository. Export them wherever
torchvision and the `lpips` package are installed,

    python scripts/export_lpips_weights.py lpips_vgg.npz

and point `LPIPS_WEIGHTS` (or the `weights` argument of `LPIPSVGG`) at the
file: conv{i}_w HWIO [3, 3, in, out], conv{i}_b [out], lin{j}_w [channels],
the convention `random_params` follows. Metrics run in fp32 with TF32 off.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gta_tpu_torch.utils.metrics import no_tf32

# VGG16 conv plan: output channels and whether a 2x2/2 max-pool precedes
# each conv, and which conv outputs (after ReLU) feed the LPIPS stages
VGG16_CONVS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
POOL_BEFORE = (False, False, True, False, True, False, False, True, False, False, True, False, False)
STAGE_AFTER_CONV = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

# lpips.LPIPS scaling layer constants
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def random_params(rng: np.random.RandomState, scale: float = 0.1) -> Dict[str, np.ndarray]:
    """Random weights in the exported-npz convention (for validation)."""
    params = {}
    c_in = 3
    for i, c_out in enumerate(VGG16_CONVS):
        params[f"conv{i}_w"] = rng.randn(3, 3, c_in, c_out).astype(np.float32) * scale
        params[f"conv{i}_b"] = rng.randn(c_out).astype(np.float32) * scale
        c_in = c_out
    for j, conv_idx in enumerate(STAGE_AFTER_CONV):
        c = VGG16_CONVS[conv_idx]
        params[f"lin{j}_w"] = np.abs(rng.randn(c).astype(np.float32)) * scale
    return params


class VGG16LPIPS(nn.Module):
    """The 13 VGG16 convs and the 5 lin weights of LPIPS-VGG, fp32."""

    def __init__(self):
        super().__init__()
        c_in, convs = 3, []
        for c_out in VGG16_CONVS:
            convs.append(nn.Conv2d(c_in, c_out, 3, padding=1))  # 3x3 "SAME"
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(nn.Parameter(torch.zeros(VGG16_CONVS[i])) for i in STAGE_AFTER_CONV)
        self.register_buffer("shift", torch.from_numpy(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)

    @classmethod
    def from_params(cls, params: Dict[str, np.ndarray]) -> "VGG16LPIPS":
        """The module with weights in the exported-npz convention."""
        net = cls()
        with torch.no_grad():
            for i, conv in enumerate(net.convs):
                conv.weight.copy_(torch.from_numpy(np.asarray(params[f"conv{i}_w"]).transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[f"conv{i}_b"])))
            for j, lin in enumerate(net.lins):
                lin.copy_(torch.from_numpy(np.asarray(params[f"lin{j}_w"])))
        return net

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """VGG16 stage features of x [B, 3, H, W], already shifted and scaled."""
        feats = []
        h = x
        for i, conv in enumerate(self.convs):
            if POOL_BEFORE[i]:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(conv(h))
            if i in STAGE_AFTER_CONV:
                feats.append(h)
        return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f**2, dim=1, keepdim=True) + eps)


@torch.no_grad()
def lpips_distance(pred: torch.Tensor, target: torch.Tensor, net: VGG16LPIPS) -> torch.Tensor:
    """LPIPS distance per batch item [B]. pred / target [B, H, W, 3] in
    [0, 1], on `net`'s device."""

    def norm_in(x):
        return ((x.float().permute(0, 3, 1, 2) * 2.0 - 1.0) - net.shift) / net.scale

    with no_tf32():
        fp = net.features(norm_in(pred))
        ft = net.features(norm_in(target))
    total = 0.0
    for lin, a, b in zip(net.lins, fp, ft):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + torch.mean(torch.sum(d * lin.view(1, -1, 1, 1), dim=1), dim=(1, 2))
    return total


class LPIPSVGG:
    """LPIPS-VGG with weights from an npz: `weights`, else the file that
    `LPIPS_WEIGHTS` names. Raises RuntimeError when neither exists."""

    def __init__(self, weights: Optional[str] = None, device: Optional[torch.device] = None):
        path = weights or os.environ.get("LPIPS_WEIGHTS", "")
        if not path or not os.path.exists(path):
            raise RuntimeError(
                "LPIPS weights not found — export with scripts/export_lpips_weights.py and set LPIPS_WEIGHTS"
            )
        with np.load(path) as loaded:
            params = {k: loaded[k] for k in loaded.files}
        self.net = VGG16LPIPS.from_params(params).to(device).eval()

    def __call__(self, pred, target) -> float:
        """Mean distance over the batch; pred / target [B, H, W, 3] in [0, 1]
        (numpy arrays or tensors)."""
        device = self.net.shift.device
        pred, target = (torch.as_tensor(x, dtype=torch.float32, device=device) for x in (pred, target))
        return float(torch.mean(lpips_distance(pred, target, self.net)))
