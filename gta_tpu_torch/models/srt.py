"""SRT / TransformingSRT model wrappers (reference models_nvs.py).

The forward pass is a function of the SceneBatch: geometry contexts are
built by pure functions and threaded explicitly. TSRT flattens
[B, Nt, P] target queries into [B, Nt*P] (models_nvs.py:81-86). The FTL
baseline transforms the *latent* by camera matrices outside attention
(models_nvs.py:61-80), with its own learnable trans_coeff, as
gta_tpu/models/srt.py:67-103 does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from gta_tpu_torch.config import ModelConfig
from gta_tpu_torch.geometry.se3 import scale_mask, se3_inverse
from gta_tpu_torch.models.context import AttnContext, SceneBatch
from gta_tpu_torch.models.decoder import SRTDecoder, build_decoder_context
from gta_tpu_torch.models.encoder import SRTEncoder, build_encoder_context
from gta_tpu_torch.models.layers import set_compute_dtype


class SRT(nn.Module):
    """Encoder-decoder novel-view-synthesis model."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SRTEncoder(cfg.encoder)
        self.decoder = SRTDecoder(cfg.decoder)

    def encode(self, batch: SceneBatch) -> Tuple[torch.Tensor, AttnContext]:
        ctx = build_encoder_context(self.cfg.encoder, batch)
        return self.encoder(batch.input_images, batch.input_camera_pos, batch.input_rays, ctx), ctx

    def decode(
        self, z: torch.Tensor, batch: SceneBatch, enc_ctx: Optional[AttnContext] = None
    ) -> Tuple[torch.Tensor, dict]:
        ctx = build_decoder_context(self.cfg.decoder, batch, enc_ctx)
        x, rays = batch.target_camera_pos, batch.target_rays
        if x.ndim == 4:  # [B, Nt, P, 3] -> [B, Nt*P, 3] (models_nvs.py:81-86)
            x = x.reshape(x.shape[0], -1, 3)
            rays = rays.reshape(rays.shape[0], -1, 3)
        return self.decoder(z, x, rays, ctx)

    def forward(self, batch: SceneBatch) -> Tuple[torch.Tensor, dict]:
        z, enc_ctx = self.encode(batch)
        return self.decode(z, batch, enc_ctx)


class TransformingSRT(SRT):
    """`tsrt` model type; with `ftl`, the FTL latent-transform baseline."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        # flax `ftl_trans_coeff`; the reference's key `trans_coeff`
        self.trans_coeff = nn.Parameter(torch.full((1,), 0.01)) if cfg.ftl else None

    def decode(
        self, z: torch.Tensor, batch: SceneBatch, enc_ctx: Optional[AttnContext] = None
    ) -> Tuple[torch.Tensor, dict]:
        if not self.cfg.ftl:
            return super().decode(z, batch, enc_ctx)
        # FTL: channel 4-vectors of z through inv(input extrinsic), then each
        # target view's extrinsic, both masked by trans_coeff
        msk = scale_mask(self.trans_coeff, z.dtype)
        iT, tT = batch.input_transforms * msk, batch.target_transforms * msk
        B, Ni, Nt = iT.shape[0], iT.shape[1], tT.shape[1]
        _, T, C = z.shape
        z = z.to(torch.promote_types(z.dtype, iT.dtype))  # fp32 tables, as jnp.einsum promotes
        zr = torch.einsum("bnij,bntcj->bntci", se3_inverse(iT), z.reshape(B, Ni, T // Ni, C // 4, 4))
        pixels = []
        for n in range(Nt):
            z_t = torch.einsum("bij,bntcj->bntci", tT[:, n], zr).reshape(B, T, C)
            view = dataclasses.replace(
                batch,
                target_coord=None if batch.target_coord is None else batch.target_coord[:, n : n + 1],
                target_transforms=tT[:, n : n + 1],
            )
            ctx = build_decoder_context(self.cfg.decoder, view, enc_ctx)
            pix, _ = self.decoder(z_t, batch.target_camera_pos[:, n], batch.target_rays[:, n], ctx)
            pixels.append(pix)
        return torch.stack(pixels, 1).reshape(B, -1, 3), {}


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> SRT:
    """The model of `cfg`, computing in `dtype` with fp32 parameters
    (gta_tpu/models/srt.py:108 `build_model(cfg, dtype)`; models/layers.py)."""
    if cfg.model_type == "srt":
        model = SRT(cfg)
    elif cfg.model_type == "tsrt":
        model = TransformingSRT(cfg)
    else:
        raise ValueError(f"unknown model_type {cfg.model_type}")
    return set_compute_dtype(model, dtype)
