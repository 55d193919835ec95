"""SRT-style multi-view patch encoder (reference encoder.py:36-345).

Images are NHWC at the API (the JAX package's layout); the conv stem runs
NCHW inside. With emb 'ray', each pixel's camera-position and ray-direction
encoding (180 channels) is concatenated to its RGB before the stem. The
stem downsamples by 2**num_conv_blocks; patch tokens from all views are
concatenated and run through a depth-`num_att_blocks` self-attention
transformer. Geometry context comes from the pure function
`build_encoder_context`.
"""

from __future__ import annotations

import torch
from torch import nn

from gta_tpu_torch.config import EncoderConfig
from gta_tpu_torch.geometry.coords import ray_posenc
from gta_tpu_torch.models.context import AttnContext, SceneBatch
from gta_tpu_torch.models.layers import Conv2d, Transformer, tagged, to_compute
from gta_tpu_torch.ops.reps import encoder_reps


def downsample_grid(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Strided center-sample downsample of [..., H, W, C] grids
    (reference common.py:105-110)."""
    if not num_steps or num_steps < 1:
        return x
    stride = 2**num_steps
    return x[..., stride // 2 :: stride, stride // 2 :: stride, :]


class SRTConvBlock(nn.Module):
    """Conv3x3(s1)-ReLU-Conv3x3(s2)-ReLU, bias-free (encoder.py:16-33)."""

    def __init__(self, idim: int, hdim: int, odim: int):
        super().__init__()
        self.layers = nn.Sequential(
            tagged(Conv2d(idim, hdim, 3, padding=1, bias=False), "jax"),
            nn.ReLU(),
            tagged(Conv2d(hdim, odim, 3, stride=2, padding=1, bias=False), "jax"),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.layers(x)


def build_encoder_context(cfg: EncoderConfig, batch: SceneBatch) -> AttnContext:
    """Precompute the encoder-side geometry context (pure function)."""
    if not cfg.attn.is_gta:
        return AttnContext()
    geom = encoder_reps(
        cfg.attn.gta, input_coord=batch.input_coord, input_transforms=batch.input_transforms
    )
    return AttnContext(geom=geom)


class SRTEncoder(nn.Module):
    """Improved SRT encoder with pluggable attention method. The images and
    ray encodings enter the conv stem in the compute dtype
    (gta_tpu/models/encoder.py:149-155)."""

    compute_dtype = torch.float32

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.emb not in (None, "ray"):
            raise NotImplementedError(
                f"encoder emb {cfg.emb!r} is not ported yet (ROADMAP queue 1 item 7: planar, camera_planar)"
            )
        self.cfg = cfg
        idim = 3 + (180 if cfg.emb == "ray" else 0)  # RGB (+ ray_posenc's 15/15 octaves)
        blocks = [SRTConvBlock(idim, cfg.dim // 8, cfg.dim // 4)]
        cur = cfg.dim // 4
        for _ in range(1, cfg.num_conv_blocks):
            blocks.append(SRTConvBlock(cur, cur, 2 * cur))
            cur *= 2
        self.conv_blocks = nn.ModuleList(blocks)
        self.per_patch_linear = tagged(Conv2d(cur, cfg.attdim, 1), "jax")
        self.transformer = Transformer(
            dim=cfg.attdim,
            depth=cfg.num_att_blocks,
            heads=cfg.heads,
            dim_head=cfg.attdim // cfg.heads,
            mlp_dim=cfg.attdim * 2,
            dropout=cfg.dropout,
            kv_dim=None,
            attn=cfg.attn,
        )

    def forward(
        self, images: torch.Tensor, camera_pos: torch.Tensor, rays: torch.Tensor, ctx: AttnContext
    ) -> torch.Tensor:
        """images, rays [B, N, H, W, 3], camera_pos [B, N, 3] -> scene latent
        [B, N*Ha*Wa, attdim]."""
        B, N, H, W, _ = images.shape
        x = to_compute(images.reshape(B * N, H, W, 3), self.compute_dtype)
        if self.cfg.emb == "ray":
            pos = camera_pos.reshape(B * N, 1, 1, 3).expand(B * N, H, W, 3)
            emb = ray_posenc(pos, rays.reshape(B * N, H, W, 3), 15, self.cfg.pos_start_octave, 15)
            x = torch.cat([x, emb.to(x.dtype)], -1)
        x = x.permute(0, 3, 1, 2)
        for block in self.conv_blocks:
            x = block(x)
        x = self.per_patch_linear(x)  # [B*N, attdim, Ha, Wa]
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.cfg.attdim)
        return self.transformer(x, None, ctx)
